"""The storage node (port of ``m3_tpu/storage/``): the ``Database`` with
its namespaces and shards, series buffers, filesets, the commit log,
snapshots and the bootstrap chain. File formats are byte for byte the
reference's, so files written by one package are read by the other."""
