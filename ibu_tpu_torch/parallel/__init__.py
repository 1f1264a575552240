"""Map-reduce over record batches on the device."""
