"""The parallel layer, ported from :mod:`crosscoder_tpu.parallel` onto
``torch.distributed``: one process (rank) a device, started by
``torchrun``; NCCL between cards, gloo between CPU processes.

- :mod:`.multihost`: joining the process group (:func:`~.multihost.initialize`),
  the primary rank, :func:`~.multihost.local_shard`;
- :mod:`.mesh`: the ``data`` × ``model`` rank grid, its process groups and
  the sharding rules of the train state;
- :mod:`.collectives`: the counted collectives and the two differentiable
  ones (a sum whose backward is the identity, and its mirror);
- :mod:`.quant_ar`: the block-scaled int8 gradient exchange
  (``cfg.quant_grads``);
- :mod:`.ring_attention`: exact attention over a sequence split across
  ranks (the sequence-parallel harvest, ``cfg.seq_shards``);
- :mod:`.comm_model`: each program's collective bytes a step, from the
  counted collectives, and the scale-out model over them.

Where the JAX package lets GSPMD partition the step or the harvest, the
port writes each collective out
(:func:`crosscoder_tpu_torch.models.crosscoder.get_losses` with a
``mesh``, :func:`crosscoder_tpu_torch.train.trainer.make_step_body`, the
tensor-parallel LM of :mod:`crosscoder_tpu_torch.models.lm`, the
mesh-sharded store of :mod:`crosscoder_tpu_torch.data.buffer`).
"""
