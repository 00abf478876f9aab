"""Multi-device training and evaluation on ``torch.distributed``.

Port of ``tsr_tpu/parallel``: ``mesh`` (the ``(data, model)`` layout of
ranks and the sharding of modules, optimizer state and batches),
``distributed`` (joining a group, per-rank data), ``collectives`` (the
autograd collectives the mesh's layers use), ``launch`` (starting ranks)
and ``dryrun`` (the flagship unified step on a mesh against one process).
"""
