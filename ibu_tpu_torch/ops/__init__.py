"""Device operations: the record codec (CUDA kernels and plain torch
versions), exact field sums and the record sort."""
