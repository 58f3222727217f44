"""Launch tooling (PyTorch port of ``repro.launch``): mesh and context
builders over ``torch.distributed`` (``launch.mesh``).  The cell
registry, dry-run, roofline and report modules are still to be ported."""
