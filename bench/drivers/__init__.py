"""One driver per kind of system a configuration names (``"system"``)."""
