"""Multi-process training and sharded synthesis (``parallel/mesh.py``)."""
