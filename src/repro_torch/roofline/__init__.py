"""The H100 roofline of the port — counterpart of ``repro.roofline``.

* :mod:`repro_torch.roofline.hw` — the H100 SXM's data-sheet constants;
* :mod:`repro_torch.roofline.kernels` — each hand-written kernel's FLOP and
  byte count from its shapes, and the bound they give on the card;
* :mod:`repro_torch.roofline.analysis` — the three-term roofline of a
  dry-run cell (``launch.dryrun``), ``napkin_bytes`` and ``model_flops``;
* :mod:`repro_torch.roofline.report` and :mod:`repro_torch.roofline.rescore`
  — the table of saved records, and their terms recomputed.

The reference's ``hlo_parse`` has no counterpart: the port has no HLO. Its
job, collective bytes per cell with every loop trip counted, is done by the
dry-run's recording mesh axes (``launch.dryrun.RecordingAxes``), which see
every trip because eager code runs them all.
"""
