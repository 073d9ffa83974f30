"""Launchers: device meshes (``mesh.py``), the sharding specs and the
store's placement on them (``sharding.py``), an LM's train state as blocks
on a mesh (``placement.py``), the join job CLI (``python -m
repro_torch.launch.join_job``), LM serving (``steps.py``, ``serve.py``:
``python -m repro_torch.launch.serve``) and training (``train.py``:
``python -m repro_torch.launch.train``; ``compressed_train.py``)."""
