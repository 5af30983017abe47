"""Sharding a model over a device mesh (the port of ``repro.parallel``):
the logical-axis rules and their resolver, ``NamedSharding`` over a
``DeviceMesh`` or a shape-only ``MeshShape``, ``shard_tree``, which
gives each rank its blocks of a tree, and the production layout's
collectives (``collectives``: FSDP's gather, tensor parallelism over
``model``, the collective log), which the layers call under a
``DeviceMesh`` installed by ``set_mesh_rules``. ``ParamCollector`` is the
reference's name for the parameter init that records each leaf's logical
axes, the port's ``models.init.ParamInit``."""
from ..models.init import ParamInit as ParamCollector
from .sharding import (LOGICAL_RULES, MeshShape, NamedSharding,
                       expert_parallel_rules, fsdp_rules, logical_sharding,
                       logical_spec, set_mesh_rules, shard, shard_tree,
                       tree_shardings)

__all__ = ["LOGICAL_RULES", "MeshShape", "NamedSharding", "ParamCollector",
           "expert_parallel_rules", "fsdp_rules", "logical_sharding", "logical_spec",
           "set_mesh_rules", "shard", "shard_tree", "tree_shardings"]
