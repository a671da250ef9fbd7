"""``pt2`` round trips of the PyTorch port's tiny graphs (detect, segment, pose, OBB, classify, v10, World;
tests/export_port.py ``check_pt2_round_trip``; RT-DETR's in tests/test_torch_export.py): the reloaded artifact
gives the live port graph's predict outputs exactly, and the JAX package's ``stablehlo`` artifact of the same
weights within rtol 1e-4 / atol 1e-4 (v10's end-to-end rows as sets, where near-tied scores may trade places).
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from export_port import FAMILIES, check_pt2_round_trip  # noqa: E402
from torch_port import share_cores  # noqa: E402

share_cores()


@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "rtdetr"])
def test_pt2_round_trip_matches_live_graph_and_jax_artifact(family, tmp_path):
    check_pt2_round_trip(family, tmp_path)
