"""One process of a two-process sharded encode of jpegtpu_torch (torch
and the port only; tests/test_torch_sharding.py starts two).

Run: python torch_multiproc_worker.py <tcp port> <rank> <world size>
<out prefix> <device>. Each process joins a gloo group on localhost,
builds the mesh of one shard a process on <device>, encodes a gray image
(1- and 2-pass) and an RGB one at 4:2:0, and writes the files to
<out prefix>.<name>.p<rank>.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from jpegtpu_torch import EncodeConfig  # noqa: E402
from jpegtpu_torch.color_pipeline import encode_color_sharded  # noqa: E402
from jpegtpu_torch.parallel import multihost, sharding  # noqa: E402


def image():
    """The test's content: 128 x 64 gray, and RGB from it."""
    img = (np.arange(128 * 64, dtype=np.int64).reshape(128, 64) * 7
           % 256).astype(np.uint8)
    return img, np.stack([img, img[::-1], img[:, ::-1]], axis=-1)


if __name__ == "__main__":
    port, rank, world, out, device = sys.argv[1:6]
    rank, world = int(rank), int(world)
    multihost.initialize(f"tcp://localhost:{port}", world_size=world,
                         rank=rank, timeout_s=120)
    multihost.initialize(f"tcp://localhost:{port}", world_size=world,
                         rank=rank)  # idempotent
    assert multihost.process_count() == world
    mesh = multihost.global_mesh([device])
    assert len(mesh) == world
    assert multihost.local_shard_indices(mesh) == [rank]
    gray, rgb = image()
    files = {
        "gray": sharding.encode_grayscale_sharded(
            gray, EncodeConfig(dct_dtype="int32"), mesh=mesh),
        "grayopt": sharding.encode_grayscale_sharded(
            gray, EncodeConfig(dct_dtype="int32", optimize_huffman=True),
            mesh=mesh),
        "color": encode_color_sharded(
            rgb, EncodeConfig(subsampling="420", dct_dtype="int32"),
            mesh=mesh),
    }
    for name, data in files.items():
        with open(f"{out}.{name}.p{rank}", "wb") as f:
            f.write(data)
    print(f"WORKER_OK {rank}", flush=True)
