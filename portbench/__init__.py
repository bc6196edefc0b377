"""The benchmark of ``bluefog_tpu_torch``: decentralized training on H100s.

``BENCHMARK.json`` at the root of the repository lists the configurations,
the cells and the metrics; everything that belongs to one of them sits in a
file of its own under this folder, found by its name:

  * ``configs/<config>.json``: a model configuration (sizes, source, what
    departs from the published model, the builder that runs it);
  * ``cells/<cell>.json``: the job of one cell (batch, sequence or image
    size, optimizer, world, topology, the pool of input batches, the
    limits of the output check, and an optional ``env`` of the
    deployment's settings, such as the allocator's, set before torch
    loads); a ``world`` above one runs a process a rank (``world.py``);
  * ``metrics/<metric>.py``: the reader of one metric;
  * ``builders/<builder>.py``: how the port's normal path is built for a
    configuration's family;
  * ``reference/<builder>.py``: the plain float32 reference of that family;
  * ``counts/``: the frozen FLOP and byte arithmetic and the card's peaks.

Run one cell with ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. Nothing here imports JAX or the JAX package,
and the reference imports nothing of the port.
"""
