"""Launchers: device meshes (``mesh.py``), the store's placement on them
(``sharding.py``), the join job CLI (``python -m
repro_torch.launch.join_job``) and LM serving (``steps.py``, ``serve.py``:
``python -m repro_torch.launch.serve``)."""
