from .ops import (flash_attention, segment_reduce, segment_reduce_lanes,
                  segment_sum, selective_scan, selective_scan_fused,
                  tile_matmul)

__all__ = ["flash_attention", "segment_reduce", "segment_reduce_lanes",
           "segment_sum", "selective_scan", "selective_scan_fused",
           "tile_matmul"]
