from .ops import (flash_attention, segment_reduce, segment_sum,
                  selective_scan, tile_matmul)

__all__ = ["flash_attention", "segment_reduce", "segment_sum",
           "selective_scan", "tile_matmul"]
