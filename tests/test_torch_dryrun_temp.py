"""A position's temp in the dry run (``launch/dryrun.py``), on the CPU
at tiny sizes: the data groups' window is its group's share.  With no
leaf stored over the data axes (qwen3), 4 rows a group give the same
data-group temp on 1x2, 2x2 and 4x2 meshes, one group or four: the
controller runs the groups in turn, so what a position holds does not
grow with the data axis.
"""
import pytest

from repro_torch.configs import get_tiny_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

B, S = 4, 32


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_a_position_holds_its_group_share(kind):
    cfg = get_tiny_config("qwen3-14b").replace(n_layers=2)
    temps = [dryrun.dry_step(cfg, ShapeConfig("t", S, B * d, kind),
                             make_test_mesh(d, 2, devices="meta"))
             ["memory"]["temp_by_phase"]["data_group"] for d in (1, 2, 4)]
    assert temps[0] > 0 and temps[0] == temps[1] == temps[2]
