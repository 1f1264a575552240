"""Host→device record streaming. The host I/O layer itself (reader, writer,
mmap, compression) is :mod:`ibu_tpu.io`, shared as it is."""
