"""The multi-device backend of the port: the counterpart of :mod:`fcvm_tpu.parallel`.

:mod:`fcvm_tpu_torch.parallel.dist` holds the process group and its
collectives, :mod:`fcvm_tpu_torch.parallel.system` the element-partition
backend :class:`~fcvm_tpu_torch.parallel.system.ShardedSystem`.
"""
