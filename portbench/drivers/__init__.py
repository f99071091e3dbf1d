"""One module an entry point of xsmm_tpu_torch, named by the traffic file's
``driver``.  Each defines ``Driver(config, traffic, device, seed, control,
spans)`` with ``calls_per_step``, ``ops_per_call``, ``bytes_per_call``,
``lookup()``, ``call(handle, s)`` on operand set ``s`` (of
``inputs.SETS``), ``release()`` and ``check(outputs)`` on (set, output)
pairs."""
