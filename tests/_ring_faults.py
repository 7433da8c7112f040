"""Faults planted in the striped ring's hop arithmetic
(`repro_torch.parallel.ring_attention.striped_hop`), shared by the CPU
tests (`test_torch_ring.py`) and the card tests (`test_torch_cuda.py`):
each takes striped_hop's arguments and must break the ring's limits."""


def no_plus_one(dist, d, mode, window):
    """The offset without its +1 for dist > 0."""
    if mode != "sliding":
        return 0, window
    w = -(-(window + dist) // d)
    return (0, w) if w >= 1 else None


def raw_window(dist, d, mode, window):
    """The window W where W' belongs."""
    return (1 if dist > 0 else 0), window
