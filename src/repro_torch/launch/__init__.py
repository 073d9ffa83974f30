"""Launchers: device meshes (``mesh.py``, ``make_production_mesh`` among
them), the sharding specs and the store's placement on them
(``sharding.py``), an LM's train state as blocks on a mesh
(``placement.py``), the join job CLI (``python -m
repro_torch.launch.join_job``; ``dryrun_ring``), LM serving (``steps.py``,
``serve.py``: ``python -m repro_torch.launch.serve``) and training
(``train.py``: ``python -m repro_torch.launch.train``;
``compressed_train.py``), and the dry-run tools: the assigned shape cells
and their meta input specs (``shapes.py``), the ATen-op analysis of a call
(``op_analysis.py``) and the dry run of every cell on a meta mesh
(``dryrun.py``: ``python -m repro_torch.launch.dryrun --all``)."""
