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
  (``cfg.quant_grads``).

Where the JAX package lets GSPMD partition the step, the port writes each
collective out (:func:`crosscoder_tpu_torch.models.crosscoder.get_losses`
with a ``mesh``, :func:`crosscoder_tpu_torch.train.trainer.make_step_body`).
Ring attention, the sharded LM harvest, the mesh-sharded replay store,
``shard_sources`` and the communication model are not ported yet.
"""
