"""reference python/paddle/v2/master/: ctypes client onto the Go master's
C shared library. Here the same surface fronts distributed.master's TCP
MasterClient — no C library, no etcd; the endpoint is the master's
host:port."""
from .client import client  # noqa: F401
