"""Data parallelism over ``torch.distributed``: the date axis
(``mesh.py``) and a local launcher for N-rank jobs (``launch.py``)."""
