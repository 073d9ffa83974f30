"""Launchers: device meshes (``mesh.py``), the store's placement on them
(``sharding.py``) and the join job CLI (``python -m
repro_torch.launch.join_job``)."""
