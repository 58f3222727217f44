"""Launch tooling (PyTorch port of ``repro.launch``): mesh and context
constructors over ``torch.distributed`` (``launch.mesh``), the cell registry
(``launch.cells``), the dry run on a fake world of 256 / 512 ranks
(``launch.dryrun``), the H100 roofline (``launch.roofline``) and the
report (``launch.report``)."""
