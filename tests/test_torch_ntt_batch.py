"""The port's NTT over a leading batch axis, [..., n, 8], on the CPU: each
transform of the batch independent, sharing the twiddles and the last
pass's scale, as the JAX package's `ntt` treats leading axes
(zkpoa_tpu/ops/ntt.py:70-73, 94-96; `prove_batched` stacks its operands,
the four-step NTT transforms rows and columns). `ntt` (forward and
inverse), `coset_qap_evals` and `quotient` on [3, 2^k, 8], k in {1, 4, 8},
against the JAX functions on [3, 2^k, 16], decoded to integers; the pass
schedule's plain version at tile logs that split a transform into several
passes, on a batch and on two leading axes, against the per-stage plain
version and each row alone; `ntt_kernel` refuses a CPU tensor and a view.
Inputs are numpy-seeded; tolerance zero."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
from zkpoa_tpu.fields.bn254 import R
from zkpoa_tpu.ops import ntt as JN
from zkpoa_tpu.ops.limbs import BN254_FR as JFR
from zkpoa_tpu_torch.ops import ntt as N
from zkpoa_tpu_torch.ops.limbs import BN254_FR

torch.set_num_threads(1)

BATCH = 3
LOG_NS = [1, 4, 8]


def _values(log_n, k):
    """[BATCH][2^log_n] field integers of operand k."""
    rng = np.random.default_rng(1000 * log_n + k)
    return [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(1 << log_n)]
            for _ in range(BATCH)]


def _port(log_n, k):
    return torch.stack([BN254_FR.encode(v, "cpu") for v in _values(log_n, k)])


def _jax(log_n, k):
    import jax.numpy as jnp

    return jnp.stack([JFR.encode(v) for v in _values(log_n, k)])


def _rows(decoded, n):
    return [decoded[i * n:(i + 1) * n] for i in range(len(decoded) // n)]


def _decode_jax(out):
    return [int(v) for v in JFR.decode(out.reshape(-1, out.shape[-1]))]


@pytest.mark.parametrize("what", ["fwd", "inv", "coset", "quotient"])
@pytest.mark.parametrize("log_n", LOG_NS)
def test_batched_transforms_match_jax(log_n, what):
    n = 1 << log_n
    if what in ("fwd", "inv"):
        got = N.ntt(_port(log_n, 0), inverse=what == "inv")
        want = JN.ntt(_jax(log_n, 0), inverse=what == "inv")
    else:
        port_fn, jax_fn = {"coset": (N.coset_qap_evals, JN.coset_qap_evals),
                           "quotient": (N.quotient, JN.quotient)}[what]
        got = port_fn(*(_port(log_n, k) for k in range(3)))
        want = jax_fn(*(_jax(log_n, k) for k in range(3)))
    assert tuple(got.shape) == (BATCH, n, 8)
    assert BN254_FR.decode(got.reshape(-1, 8)) == _decode_jax(want)


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_batched_pass_schedule_equals_each_row(t, inverse):
    """Several passes (tile log t < log_n) with the scale table in the last:
    the batch equals each row transformed alone, and the per-stage plain
    version on the batch; two leading axes flatten to the same batch."""
    log_n = 8
    n = 1 << log_n
    x = _port(log_n, 1)
    scale = N.pow_table(5, n, "cpu", scale=pow(n, -1, R))
    got = N.ntt_passes_plain(x, inverse, scale, tile_log=t)
    for i in range(BATCH):
        assert torch.equal(got[i], N.ntt_passes_plain(x[i], inverse, scale, tile_log=t))
    per_stage = N._apply_scale_plain(N.ntt_plain(x, inverse), scale)
    if inverse:  # ntt_plain folds 1/n in itself
        per_stage = N._apply_scale_plain(per_stage, BN254_FR.encode([n], "cpu"))
    assert torch.equal(got, per_stage)
    x4 = torch.cat([x, x[:1]]).reshape(2, 2, n, 8)
    got4 = N.ntt_passes_plain(x4, inverse, scale, tile_log=t)
    assert torch.equal(got4.reshape(4, n, 8)[:BATCH], got)


def test_kernel_refuses_cpu_tensors_and_views():
    x = _port(4, 0)
    with pytest.raises(ValueError, match="CUDA"):
        N.ntt_kernel(x)
    with pytest.raises(ValueError, match="contiguous"):
        N.ntt_kernel(x.transpose(0, 1))
    with pytest.raises(ValueError, match="power of two"):
        N.ntt_kernel(x[:, :3].contiguous())
