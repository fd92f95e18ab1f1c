"""Distributed training — counterpart of ``deeplearning4j_tpu/parallel``
over ``torch.distributed`` process groups (NCCL on the card, gloo on the
CPU): ``ParallelWrapper`` in its four modes, the gradient codec, ZeRO-1's
layout rule, ``MultiHostTrainer`` with ``ProcessShardIterator``,
``ParallelInference``, the mesh helpers and the spawned CPU rank groups
that stand in for ``cpu_test_mesh``; and the model and sequence
parallelism DL4J lacks: the sharding rule tables, ``place_params``,
activation sharding (``Trainer(mesh=, rules=)``), ring attention on the
flash kernels and the GPipe schedule, with the differentiable collectives
they are built on (``collectives``).
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
from .pipeline import (from_microbatches, pipeline_apply,
                       stack_stage_params, to_microbatches)
from .ring_attention import (reference_attention, ring_attention,
                             ring_attention_blocks, ring_attention_local,
                             ring_step, ring_step_backward)
from .sharding import (CNN_RULES, DENSE_RULES, TRANSFORMER_RULES,
                       MeshContext, activation_sharding, batch_sharding,
                       constrain_activations, gather_params, place_batch,
                       place_params, shard_params, sharding_tree, spec_for,
                       zero_opt_spec, zero_shard_dim)
from .wrapper import ParallelWrapper

__all__ = ["CNN_RULES", "DATA_AXIS", "DENSE_RULES", "EXPERT_AXIS",
           "EncodedGradientsAccumulator", "MODEL_AXIS", "Mesh", "MeshContext",
           "MultiHostTrainer", "PIPE_AXIS", "ParallelInference",
           "ParallelWrapper", "ProcessShardIterator", "RankGroup",
           "SEQ_AXIS", "SparseUpdate", "TRANSFORMER_RULES", "TopKUpdate",
           "activation_sharding", "auto_capacity_frac", "batch_sharding",
           "bitmap_decode", "bitmap_encode", "constrain_activations",
           "distributed_init", "from_microbatches", "gather_params",
           "initialize_multihost", "local_device_count", "make_mesh",
           "pipeline_apply", "place_batch", "place_params", "process_count",
           "reference_attention", "replicate", "ring_attention",
           "ring_attention_blocks", "ring_attention_local", "ring_step",
           "ring_step_backward", "run_ranks", "shard_batch", "shard_params",
           "sharding_tree", "spec_for", "stack_stage_params",
           "threshold_decode", "threshold_encode", "to_microbatches",
           "topk_decode", "topk_encode", "zero_opt_spec", "zero_shard_dim"]
