"""rot-GICP objective and batched LM solvers (counterpart of
rolo_tpu/registration)."""

from .gicp import Correspondences, GICPContext, make_context, update_correspondences
from .lm import CTResult, LMResult, lm_register_rotation, lm_register_se3, lm_translation
from .rotgicp import ScanPairResult, register_scan_pair, register_se3

__all__ = [
    "GICPContext",
    "Correspondences",
    "make_context",
    "update_correspondences",
    "LMResult",
    "CTResult",
    "lm_register_rotation",
    "lm_register_se3",
    "lm_translation",
    "ScanPairResult",
    "register_scan_pair",
    "register_se3",
]
