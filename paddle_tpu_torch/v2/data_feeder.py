"""reference python/paddle/v2/data_feeder.py — the v2 DataFeeder is the
fluid DataFeeder (ragged reader rows -> padded+lengths feed dicts)."""
from ..fluid.data_feeder import DataFeeder  # noqa: F401
