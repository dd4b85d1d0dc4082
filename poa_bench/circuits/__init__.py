"""Circuit kinds: `circuits/<kind>.py` builds a cell's pool through the
program's own frontend and setup; `reference/<kind>.py` states its public
values from the same seeds."""
