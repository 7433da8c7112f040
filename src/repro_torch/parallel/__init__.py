"""Context parallelism: ring attention over a `Ring` of ranks."""
from .ring_attention import (DistRing, LocalRing, Ring, make_positions,
                             ring_attention, ring_decode_attention,
                             shard_sequence, striped_hop)

__all__ = ["DistRing", "LocalRing", "Ring", "make_positions",
           "ring_attention", "ring_decode_attention", "shard_sequence",
           "striped_hop"]
