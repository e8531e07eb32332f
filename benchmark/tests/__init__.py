"""The benchmark's CPU tests (and its card tests, marked ``chip``)."""
