"""Each kernel's bytes and operations: what the function needs on the
cell's data, whatever kernel carries it, one file per function."""
