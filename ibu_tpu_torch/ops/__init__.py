"""Device operations: the 2-bit codec (CUDA kernels and plain torch
versions, fused record and single field), exact field sums, the record sort
and the barcode-grouped aggregations."""
