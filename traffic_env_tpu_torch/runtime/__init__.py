"""Host-side runtimes: the native C++ simulator (``native.py``)."""
