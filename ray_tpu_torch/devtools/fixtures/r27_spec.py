"""R27 fixture: mesh/spec consistency over the abstract sharding model.

Positive cases: ``BAD_RULES`` maps a logical axis to a mesh axis no mesh
declares, ``BAD_AXIS_SPEC`` names an unknown mesh axis, ``DUP_SPEC``
binds one mesh axis to two dims of a single spec, ``build`` passes a
2-entry ``in_placements`` to a 3-argument ``local_map`` callee, and
``make_specs``/``override`` use a logical name absent from every rules
table / an unknown override mesh axis.  Clean twins mirror each case
with valid axes.
"""

from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.parallel.sharding import spec_to_placements
from ray_tpu_torch.parallel.spmd import psum

AXIS_ORDER = ("data", "tensor")
RULES = {"batch": "data", "mlp": "tensor"}
BAD_RULES = {"embed": "fsdp_typo"}

GOOD_SPEC = spec_to_placements(None, ("data", "tensor"))
GOOD_TUPLE_SPEC = spec_to_placements(None, (("data", "tensor"), None))
BAD_AXIS_SPEC = spec_to_placements(None, ("data", "rows"))
DUP_SPEC = spec_to_placements(None, ("data", "data"))


def _body3(a, b, c):
    return psum(a, None, "data")


def build(mesh):
    good = local_map(_body3, out_placements=(Shard(0),),
                     in_placements=((Shard(0),), None, (Replicate(),)),
                     device_mesh=mesh)
    bad = local_map(_body3, out_placements=(Shard(0),),
                    in_placements=((Shard(0),), None),
                    device_mesh=mesh)
    return good, bad


def make_specs(rules):
    ok = rules.spec(("batch", "mlp"))
    bad = rules.spec(("batch", "typo_axis"))
    return ok, bad


def override(rules):
    ok = rules.with_overrides(batch="tensor")
    bad = rules.with_overrides(batch="ghost")
    return ok, bad
