"""Companion pipeline tools (SURVEY.md §2.2), Python 3 (copies of
dbgtpu/tools; ggmap maps with this package's command line).

Modern equivalents of the reference's helper binary + Python-2 scripts:
  get_large_unitigs   getLargeUnitigs.cpp:43-74
  dbg_construction    DBGconstruction.py (dsk -> bcalm pipeline)
  ggmap               GGMAP.py (map, then bowtie2 the leftovers)
  convert_one_line    convertOneLineFasta.py
  no_n                noN.py

Each is runnable as `python -m dbgtpu_torch.tools.<name>`; `exp_gather`
(the gather kernels K9-K12 against the PyTorch gather) is this package's
own.
"""
