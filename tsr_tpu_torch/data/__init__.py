"""Host-side data loading for the port (``data/gtsrb.py``)."""
