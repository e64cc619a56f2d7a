"""The two back-end cycles `rolo_tpu/runtime/slam.py` builds as programs of
its own, as plain functions: the live ground-map update at the mapping
cadence (`_ground_update_jit`, slam.py:93-104) and the 5 Hz prior cycle
(`_prior_cycle_jit`, slam.py:228-252). `SlamSystem.process_scan` runs
both inline: the ground update at each mapping step, the prior cycle at its
5 Hz cadence beside the scheduler's queue of loop ticks and solves.
"""

from __future__ import annotations

import torch

from ..config import RoloConfig
from ..filter import fusion
from ..geometry import so3
from ..mapping import backend
from ..pointcloud.ground_seg import segment_ground
from ..pointcloud.projection import RingImage
from ..prior import association, ground
from ..prior.vehicle import VehicleModel
from . import profiling


def ground_update(live: ground.LiveGroundMap, ring_img: RingImage, rot: torch.Tensor,
                  trans: torch.Tensor, cfg: RoloConfig) -> ground.LiveGroundMap:
    """Segment this scan's ground and insert it at the mapped pose."""
    st = cfg.static
    g = segment_ground(ring_img, cfg.sensor.horizon_scan,
                       cfg.prior.ground_seg_rings or cfg.sensor.n_scan // 2,
                       cfg.prior.ground_seg_slope_deg, out_capacity=st.live_ground_slot_points * 4)
    return ground.update_live_ground(live, g, rot, trans, st.live_ground_slot_points)


def prior_cycle(fusion_state: fusion.FusionState, stamp, backend_state: backend.BackendState,
                ground_map: ground.GroundMap, vehicle: VehicleModel, cfg: RoloConfig):
    """predictTimerHandler -> prior_pose_node -> priorInfoHandler ->
    performPriorAssociation: the filter's future pose in the world, the
    contact solve and ground patch there, the observation recorded against
    the latest keyframe, then one association pass against the ground
    around the current pose. Returns (backend_state, matched). In an active
    tracer the rollout and the contact solve are the spans `prior.predict`
    and `prior.contact`."""
    with profiling.span("prior.predict", sync=lambda: fut.final_pos):
        fut = fusion.predict_future(fusion_state, cfg.filter)
    fused = fusion.fused_pose(fusion_state, stamp, cfg.filter)
    world_pos = fused.rot @ fut.final_pos + fused.trans
    world_rot = fused.rot @ so3.quat_to_matrix(fut.final_quat)
    yaw = torch.atan2(world_rot[1, 0], world_rot[0, 0])
    with profiling.span("prior.contact", sync=lambda: obs.success):
        obs = association.compute_prior(ground_map, vehicle, world_pos[0], world_pos[1], yaw,
                                         cfg.prior, 2048)
    obs = obs._replace(success=obs.success & fut.valid & fused.valid)
    backend_state = backend.record_prior_observation(backend_state, obs, obs_time=stamp, cfg=cfg)
    patch = ground.extract_patch(ground_map, backend_state.xyz[:2],
                                 4.0 * cfg.prior.ground_patch_size, 4096)
    return backend.prior_step(backend_state, patch, cfg)
