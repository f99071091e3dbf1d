"""The distributed layer (the port of ``xsmm_tpu/parallel``): the mesh and
its collectives, the ring and column-sharded SpMM and the data-parallel
wrappers, multi-process runs, and the ring's schedule check."""
