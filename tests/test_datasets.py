"""TUM/KITTI sequence readers (Examples/Monocular/mono_tum.cc /
mono_kitti.cc loader parity) on synthetic folders."""
import os

import numpy as np

from mc_slam.io.datasets import load_kitti_sequence, load_tum_sequence


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def test_tum_reader_and_depth_association(tmp_path):
    root = str(tmp_path)
    _write(os.path.join(root, "rgb.txt"),
           "# comment\n"
           "100.00 rgb/100.00.png\n"
           "100.05 rgb/100.05.png\n"
           "100.10 rgb/100.10.png\n")
    _write(os.path.join(root, "depth.txt"),
           "100.008 depth/100.008.png\n"
           "100.30 depth/100.30.png\n")
    seq = load_tum_sequence(root)
    assert len(seq) == 3
    assert seq[0][0] == 100.0
    assert seq[0][1].endswith("rgb/100.00.png")
    # with depth: only the first rgb frame has a depth within 0.02 s
    seq_d = load_tum_sequence(root, with_depth=True)
    assert len(seq_d) == 1
    assert seq_d[0][2].endswith("depth/100.008.png")


def test_kitti_reader(tmp_path):
    root = str(tmp_path)
    _write(os.path.join(root, "times.txt"), "0.0\n0.103\n0.207\n")
    seq = load_kitti_sequence(root)
    assert len(seq) == 3
    assert seq[1][0] == 0.103
    assert seq[2][1].endswith(os.path.join("image_0", "000002.png"))
