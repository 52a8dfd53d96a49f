"""Parallelism over ``torch.distributed``: the (seed × data × seq) mesh
(``mesh.py``), sequence parallelism (``ring.py``) and a local launcher
for N-rank jobs (``launch.py``)."""
