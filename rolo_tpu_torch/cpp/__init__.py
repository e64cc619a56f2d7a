"""The native host library (cpp/rolo_host.cpp) through ctypes: PCD / KITTI
decode, the rosbag reader and a prefetch queue. Built with g++ at first use;
see `host.py`."""

from .host import (BagReader, ScanPrefetchQueue, is_available, library_path,
                   read_kitti_bin_native, read_pcd_native)

__all__ = ["BagReader", "ScanPrefetchQueue", "is_available", "library_path",
           "read_kitti_bin_native", "read_pcd_native"]
