"""Command-line launchers of the port (``python -m
repro_torch.launch.serve``, ``.join``, ``.train``) and the dry run
(``python -m repro_torch.launch.dryrun``, over ``mesh``, ``specs`` and
``cost``: each cell's fit and roofline without a card)."""
