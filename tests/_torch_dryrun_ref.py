"""The reference side of ``tests/test_torch_dryrun.py``, run as a script in
a process of its own: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host
devices) when it is imported, so the pytest process never imports it.
Writes one JSON object to the path it is given:

    python tests/_torch_dryrun_ref.py OUT.json

  bytes   per (arch, mesh, profile): the per-device parameter and optimizer
          bytes of ``make_shardings`` over the reference's own production
          mesh (``NamedSharding.shard_shape``, nothing compiled)
  flops   per profile: ``run_cell``'s ``flops_per_device`` (hloparse) for
          reduced qwen1.5-0.5b at train_4k, 2 microbatches, its mesh
          patched to (2, 2) over 4 of the host devices and its config to
          the reduced one at the full config's attention chunks (the port's
          ``dryrun --reduced``)
"""
import dataclasses
import json
import math
import sys

from repro.launch import dryrun  # sets XLA_FLAGS before jax starts

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import configs  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models import base, transformer  # noqa: E402

MESHES = {"single_pod": False, "multi_pod": True}


def shard_bytes() -> dict:
    out = {}
    for arch in configs.ARCH_NAMES:
        defs = transformer.model_defs(configs.get(arch))
        leaves = jax.tree.leaves(defs, is_leaf=lambda d: isinstance(d, base.ParamDef))
        for name, mp in MESHES.items():
            mesh = make_production_mesh(multi_pod=mp)
            for profile in ("tp", "fsdp"):
                rules, _, _ = base.rules_for_profile(profile)
                shardings = jax.tree.leaves(base.make_shardings(defs, mesh, rules))
                n = sum(math.prod(sh.shard_shape(d.shape)) for d, sh in zip(leaves, shardings))
                # fp32 leaves; AdamState: the int32 step, mu and nu in fp32
                out[f"{arch}|{name}|{profile}"] = [4 * n, 4 + 8 * n]
    return out


def flops() -> dict:
    full_get = configs.get

    def reduced(arch):
        full = full_get(arch)
        return dataclasses.replace(configs.get_reduced(arch), attn_q_chunk=full.attn_q_chunk,
                                   attn_kv_chunk=full.attn_kv_chunk)

    configs.get = reduced
    dryrun.make_production_mesh = lambda multi_pod=False: Mesh(
        np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    return {p: dryrun.run_cell("qwen1.5-0.5b", "train_4k", profile=p, n_micro=2)["flops_per_device"]
            for p in ("fsdp", "tp")}


if __name__ == "__main__":
    result = {"bytes": shard_bytes(), "flops": flops()}
    with open(sys.argv[1], "w") as f:
        json.dump(result, f)
