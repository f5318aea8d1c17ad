def ceil_to(x: int, m: int) -> int:
    """``x`` rounded up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m
