"""Traffic runners, one a module, and the mixes they read (``<mix>.json``)."""
