"""Multi-GPU training: the process grid (`mesh.py`), the halo exchanges of
a frame split in height (`spatial.py`) and the sharded-step dryrun
(`dryrun.py`)."""
