"""Distributed training — counterpart of ``deeplearning4j_tpu/parallel``,
its data-parallel half over ``torch.distributed`` process groups (NCCL on
the card, gloo on the CPU): ``ParallelWrapper`` in its four modes, the
gradient codec, ZeRO-1's layout rule, ``MultiHostTrainer`` with
``ProcessShardIterator``, ``ParallelInference``, the mesh helpers and the
spawned CPU rank groups that stand in for ``cpu_test_mesh``.

Tensor, sequence and pipeline parallelism (the sharding rule tables,
``place_params``, activation sharding, ``ring_attention``, the pipeline
helpers) are not ported yet (ROADMAP.md, Queue 1: item 19): those names
raise ``NotImplementedError``.
"""

from .compression import (EncodedGradientsAccumulator, SparseUpdate,
                          TopKUpdate, auto_capacity_frac, bitmap_decode,
                          bitmap_encode, threshold_decode, threshold_encode,
                          topk_decode, topk_encode)
from .inference import ParallelInference
from .mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
                   Mesh, RankGroup, distributed_init, local_device_count,
                   make_mesh, process_count, replicate, run_ranks,
                   shard_batch)
from .multihost import (MultiHostTrainer, ProcessShardIterator,
                        initialize_multihost)
from .sharding import (NOT_PORTED_RULES, activation_sharding,
                       constrain_activations, not_ported, place_params,
                       shard_params, sharding_tree, zero_opt_spec,
                       zero_shard_dim)
from .wrapper import ParallelWrapper

ring_attention = not_ported("ring_attention")
ring_attention_local = not_ported("ring_attention_local")
reference_attention = not_ported("reference_attention")
pipeline_apply = not_ported("pipeline_apply")
stack_stage_params = not_ported("stack_stage_params")
to_microbatches = not_ported("to_microbatches")
from_microbatches = not_ported("from_microbatches")
batch_sharding = not_ported("batch_sharding")
place_batch = not_ported("place_batch")


def __getattr__(name):
    if name in ("CNN_RULES", "DENSE_RULES", "TRANSFORMER_RULES"):
        raise NotImplementedError(f"parallel.{name} is {NOT_PORTED_RULES}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["DATA_AXIS", "EXPERT_AXIS", "EncodedGradientsAccumulator",
           "MODEL_AXIS", "Mesh", "MultiHostTrainer", "PIPE_AXIS",
           "ParallelInference", "ParallelWrapper", "ProcessShardIterator",
           "RankGroup", "SEQ_AXIS", "SparseUpdate", "TopKUpdate",
           "activation_sharding", "auto_capacity_frac", "batch_sharding",
           "bitmap_decode", "bitmap_encode", "constrain_activations",
           "distributed_init", "from_microbatches", "initialize_multihost",
           "local_device_count", "make_mesh", "pipeline_apply",
           "place_batch", "place_params", "process_count",
           "reference_attention", "replicate", "ring_attention",
           "ring_attention_local", "run_ranks", "shard_batch",
           "shard_params", "sharding_tree", "stack_stage_params",
           "threshold_decode", "threshold_encode", "to_microbatches",
           "topk_decode", "topk_encode", "zero_opt_spec", "zero_shard_dim"]
