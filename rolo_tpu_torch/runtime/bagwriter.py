"""Minimal rosbag v2 writer for PointCloud2 sequences, the port's own copy of
`rolo_tpu/runtime/bagwriter.py` (numpy only).

Counterpart of the native reader (cpp/rolo_host.cpp index_bag /
rolo_bag_read_pointcloud2): one uncompressed chunk holding a connection
record plus time-ordered message-data records, the subset of the format the
replay path needs. It makes recorded-data fixtures from the simulator, so the
BagReader -> SlamSystem path runs end to end without ROS.

Wire format (rosbag 2.0): magic line, then records of (u32 header_len,
header fields, u32 data_len, data); header fields are (u32 len, "name=" +
raw value bytes).
"""

from __future__ import annotations

import struct
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

_PC2_MD5 = "1158d486dd51d683ce2f1be655c3c181"
_PC2_TYPE = "sensor_msgs/PointCloud2"


def _field(name: str, value: bytes) -> bytes:
    payload = name.encode() + b"=" + value
    return struct.pack("<I", len(payload)) + payload


def _record(header_fields: Sequence[bytes], data: bytes) -> bytes:
    header = b"".join(header_fields)
    return struct.pack("<I", len(header)) + header + struct.pack("<I", len(data)) + data


def _ros_time(stamp: float) -> Tuple[int, int]:
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    if nsec >= 1_000_000_000:
        sec, nsec = sec + 1, nsec - 1_000_000_000
    return sec, nsec


def serialize_pointcloud2(
    stamp: float,
    xyz: np.ndarray,
    intensity: Optional[np.ndarray] = None,
    ring: Optional[np.ndarray] = None,
    rel_time: Optional[np.ndarray] = None,
    frame_id: str = "velodyne",
    seq: int = 0,
) -> bytes:
    """Serialized sensor_msgs/PointCloud2 with the Velodyne field layout the
    reference normalizes to (utility.h:68-80): x/y/z/intensity f32, ring
    u16, time f32."""
    n = len(xyz)
    xyz = np.asarray(xyz, np.float32)
    intensity = (np.zeros(n, np.float32) if intensity is None
                 else np.asarray(intensity, np.float32))
    ring = np.zeros(n, np.uint16) if ring is None else np.asarray(ring).astype(np.uint16)
    rel_time = (np.zeros(n, np.float32) if rel_time is None
                else np.asarray(rel_time, np.float32))

    point_step = 22  # 3*4 + 4 + 2 + 4
    buf = np.zeros((n, point_step), np.uint8)
    buf[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    buf[:, 12:16] = intensity.view(np.uint8).reshape(n, 4)
    buf[:, 16:18] = ring.view(np.uint8).reshape(n, 2)
    buf[:, 18:22] = rel_time.view(np.uint8).reshape(n, 4)
    data = buf.tobytes()

    sec, nsec = _ros_time(stamp)
    out = [struct.pack("<III", seq, sec, nsec)]
    fid = frame_id.encode()
    out.append(struct.pack("<I", len(fid)) + fid)
    out.append(struct.pack("<II", 1, n))  # height, width

    # sensor_msgs/PointField: datatype 7=f32, 4=u16
    fields = [(b"x", 0, 7), (b"y", 4, 7), (b"z", 8, 7),
              (b"intensity", 12, 7), (b"ring", 16, 4), (b"time", 18, 7)]
    out.append(struct.pack("<I", len(fields)))
    for name, off, dt in fields:
        out.append(struct.pack("<I", len(name)) + name + struct.pack("<IBI", off, dt, 1))
    out.append(struct.pack("<BII", 0, point_step, point_step * n))
    out.append(struct.pack("<I", len(data)))
    out.append(data)
    out.append(struct.pack("<B", 1))  # is_dense
    return b"".join(out)


def write_bag(
    path: str,
    scans: Iterable[Tuple[float, np.ndarray, Optional[np.ndarray], Optional[np.ndarray],
                          Optional[np.ndarray]]],
    topic: str = "/points_raw",
    frame_id: str = "velodyne",
) -> int:
    """Write scans [(stamp, xyz, intensity|None, ring|None, rel_time|None)]
    as one uncompressed-chunk rosbag v2. Returns the message count."""
    chunk_parts = []
    # connection record: topic on the record header; type/md5 in the data
    conn_data = b"".join([
        _field("topic", topic.encode()),
        _field("type", _PC2_TYPE.encode()),
        _field("md5sum", _PC2_MD5.encode()),
        _field("message_definition", b""),
    ])
    chunk_parts.append(_record(
        [_field("op", b"\x07"), _field("conn", struct.pack("<I", 0)),
         _field("topic", topic.encode())],
        conn_data,
    ))

    count = 0
    for seq, (stamp, xyz, intensity, ring, rel_time) in enumerate(scans):
        sec, nsec = _ros_time(stamp)
        msg = serialize_pointcloud2(stamp, xyz, intensity, ring, rel_time, frame_id=frame_id,
                                    seq=seq)
        chunk_parts.append(_record(
            [_field("op", b"\x02"), _field("conn", struct.pack("<I", 0)),
             _field("time", struct.pack("<II", sec, nsec))],
            msg,
        ))
        count += 1

    chunk = b"".join(chunk_parts)
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        # bag header record (op=0x03), padded to the standard 4096 bytes
        bh = _record(
            [_field("op", b"\x03"),
             _field("index_pos", struct.pack("<Q", 0)),
             _field("conn_count", struct.pack("<I", 1)),
             _field("chunk_count", struct.pack("<I", 1))],
            b"",
        )
        pad = 4096 + 8 - len(bh)
        f.write(bh[:-4] + struct.pack("<I", pad) + b" " * pad)
        f.write(_record(
            [_field("op", b"\x05"), _field("compression", b"none"),
             _field("size", struct.pack("<I", len(chunk)))],
            chunk,
        ))
    return count
