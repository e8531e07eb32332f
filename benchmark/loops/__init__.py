"""The loops that drive the program, one file each: ``<loop>.py`` with
``run(run)``. A traffic mix (``traffic/<mix>.json``) names its loop by
the key ``loop`` and holds the parameters the loop reads; the harness
imports the loop by that name (``harness/registry.py``), so a new kind
of traffic is a new file here and never an edit."""
