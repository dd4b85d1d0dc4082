/* A witness's Python ints to plain 8 x u32 limbs, in one pass on the host.
 *
 * The prover uploads each witness as an [n, 8] int32 array of little-endian
 * u32 limbs of the values mod R. Doing that in Python costs a `% R` and a
 * `to_bytes` per value; this routine reads each item of the sequence once
 * and writes its limbs straight into the caller's array. An exact `int` in
 * [0, R) is converted here; every other item (a negative value, a value of
 * R or more, a bool, a numpy integer, an int subclass, any other object)
 * is a miss: its index goes to `miss` and the caller converts it with the
 * exact `int(x) % R` rule. The row of a miss is left unspecified.
 *
 * It uses the Python C API, so it is built against the running
 * interpreter's headers (`_build.py` `host_lib`), loaded with
 * `ctypes.PyDLL` (the interpreter lock stays held) and called with the
 * sequence as a `py_object`. It calls no Python code for an exact int.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "witness_limbs.c writes the value's little-endian bytes as its u32 limbs"
#endif

/* R, the order of BN254's scalar field, as little-endian u32 limbs. */
static const uint32_t R_LIMBS[8] = {
    0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u,
};

static int below_r(const uint32_t *x)
{
    for (int i = 7; i >= 0; --i)
        if (x[i] != R_LIMBS[i])
            return x[i] < R_LIMBS[i];
    return 0;
}

/* Writes the limbs of item `o` to `row`: 1 if converted, 0 for a miss, -1
 * with a Python error set. */
static int convert_one(PyObject *o, uint32_t *row)
{
    if (!PyLong_CheckExact(o))
        return 0;
#if PY_VERSION_HEX >= 0x030C0000
    /* Most values of a witness are one digit (below 2^30): read it inline. */
    if (PyUnstable_Long_IsCompact((PyLongObject *)o)) {
        Py_ssize_t d = PyUnstable_Long_CompactValue((PyLongObject *)o);
        if (d < 0)
            return 0;
        row[0] = (uint32_t)d;
        memset(row + 1, 0, 7 * sizeof(uint32_t));
        return 1;
    }
#endif
    int overflow;
    long long v = PyLong_AsLongLongAndOverflow(o, &overflow);
    if (v == -1 && PyErr_Occurred())
        return -1;
    if (!overflow) {
        if (v < 0)
            return 0;
        row[0] = (uint32_t)v;
        row[1] = (uint32_t)((unsigned long long)v >> 32);
        memset(row + 2, 0, 6 * sizeof(uint32_t));
        return 1;
    }
    if (overflow < 0)
        return 0;
#if PY_VERSION_HEX >= 0x030D0000
    Py_ssize_t need = PyLong_AsNativeBytes(
        o, row, 32, Py_ASNATIVEBYTES_LITTLE_ENDIAN | Py_ASNATIVEBYTES_UNSIGNED_BUFFER);
    if (need < 0)
        return -1;
    if (need > 32)
        return 0;
#else
    size_t bits = _PyLong_NumBits(o);
    if (bits == (size_t)-1 && PyErr_Occurred())
        return -1;
    if (bits > 254)
        return 0;
    if (_PyLong_AsByteArray((PyLongObject *)o, (unsigned char *)row, 32, 1, 0) < 0)
        return -1;
#endif
    return below_r(row);
}

/* Converts the n items of `seq` (a list or tuple is read in place, any
 * other sequence through a list) into `out` [n, 8]; writes the index of
 * each miss to `miss` (room for n). Returns the number of misses, or -1
 * with a Python error set. */
Py_ssize_t zk_witness_limbs(PyObject *seq, Py_ssize_t n, uint32_t *out, int64_t *miss)
{
    PyObject *fast = PySequence_Fast(seq, "the witness must be a sequence");
    if (fast == NULL)
        return -1;
    if (PySequence_Fast_GET_SIZE(fast) != n) {
        PyErr_Format(PyExc_ValueError, "the witness holds %zd values, the output %zd rows",
                     PySequence_Fast_GET_SIZE(fast), n);
        Py_DECREF(fast);
        return -1;
    }
    PyObject **items = PySequence_Fast_ITEMS(fast);
    Py_ssize_t misses = 0;
    for (Py_ssize_t i = 0; i < n; ++i) {
        int got = convert_one(items[i], out + 8 * i);
        if (got < 0) {
            Py_DECREF(fast);
            return -1;
        }
        if (got == 0)
            miss[misses++] = (int64_t)i;
    }
    Py_DECREF(fast);
    return misses;
}
