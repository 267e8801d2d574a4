"""Per-rank bytes of a VTP train state under FSDP, computed on the host
from the state's shapes (the model is built on the meta device, so nothing
is allocated). Two figures for each data-axis size: ``jax_rule``, the JAX
package's ZeRO-3 rule (``sharded_bytes`` of ``fsdp_state_specs``, every
large leaf of the parameters, the teacher and the moments divided), and
``port``, what a rank of this package holds once ``shard_state`` sharded
the state (``sharded_bytes`` of ``held_specs``: the same rule, the moments
cut as their parameters). Without a model axis the two are equal; the
``port`` column stays as the check that they are.

    python -m vtp_tpu_torch.tools.fsdp_plan --preset vtp-large --data 2 4 8
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional


def meta_train_state(cfg, tcfg):
    """A ``TrainState`` of ``cfg`` / ``tcfg`` on the meta device: the
    student, the DINO head, the teacher, the moments and the centers, with
    shapes and dtypes and no storage."""
    import torch

    from vtp_tpu_torch.models.dino_head import DinoHead
    from vtp_tpu_torch.models.vtp_model import VTPModel
    from vtp_tpu_torch.train.state import TrainState, make_teacher, train_leaves
    from vtp_tpu_torch.train.step import dino_head_config, make_optimizer

    model = VTPModel(cfg, device="meta")
    with torch.device("meta"):
        head = DinoHead(dino_head_config(cfg, tcfg))
    return TrainState(model, head, make_optimizer(train_leaves(model, head), tcfg),
                      make_teacher(model, head),
                      torch.empty(tcfg.dino_out_dim, device="meta"),
                      torch.empty(tcfg.dino_out_dim, device="meta"))


def plan(preset: str, data: List[int], dino_out_dim: int, moment_dtype: str) -> Dict:
    from vtp_tpu_torch.config import PRESETS
    from vtp_tpu_torch.parallel import fsdp
    from vtp_tpu_torch.train.step import TrainConfig

    cfg = PRESETS[preset]()
    tcfg = TrainConfig(dino_out_dim=dino_out_dim, moment_dtype=moment_dtype)
    tree = fsdp.train_state_tree(meta_train_state(cfg, tcfg))
    whole = fsdp.sharded_bytes(tree, fsdp.fsdp_state_specs(tree, 1), {"data": 1})
    rows = {"preset": preset, "moment_dtype": moment_dtype, "replicated_bytes": whole,
            "jax_rule": {}, "port": {}}
    for n in data:
        specs = fsdp.fsdp_state_specs(tree, n)
        rows["jax_rule"][f"data={n}"] = fsdp.sharded_bytes(tree, specs, {"data": n})
        rows["port"][f"data={n}"] = fsdp.sharded_bytes(tree, fsdp.held_specs(specs),
                                                       {"data": n})
    return rows


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="vtp-large")
    p.add_argument("--data", type=int, nargs="+", default=[2, 4, 8])
    p.add_argument("--dino_out_dim", type=int, default=65536)
    p.add_argument("--moment_dtype", default="fp32", choices=["fp32", "bf16"])
    args = p.parse_args(argv)
    out = plan(args.preset, args.data, args.dino_out_dim, args.moment_dtype)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
