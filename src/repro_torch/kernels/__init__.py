from .ops import segment_reduce, segment_sum, tile_matmul

__all__ = ["segment_reduce", "segment_sum", "tile_matmul"]
