"""Scan Context place recognition and loop-closure verification (counterpart
of rolo_tpu/loop)."""

from .closure import (
    ICPResult,
    LoopFactor,
    assemble_loop_submap,
    detect_loop_distance,
    icp_point2point,
    verify_loop,
)
from .scancontext import (
    LoopDetection,
    ScanContextDB,
    add_descriptor,
    detect_loop,
    init_db,
    make_descriptor,
    ring_key,
    sector_key,
)

__all__ = [
    "ICPResult",
    "LoopFactor",
    "assemble_loop_submap",
    "detect_loop_distance",
    "icp_point2point",
    "verify_loop",
    "LoopDetection",
    "ScanContextDB",
    "add_descriptor",
    "detect_loop",
    "init_db",
    "make_descriptor",
    "ring_key",
    "sector_key",
]
