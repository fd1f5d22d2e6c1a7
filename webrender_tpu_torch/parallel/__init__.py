"""Multi-device rendering over `torch.distributed`: the tile-sharded raster
path (`mesh.py`) and its dry run (`dryrun.py`)."""
