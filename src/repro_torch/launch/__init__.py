"""repro_torch.launch — meshes over ``torch.distributed``, the training
step factories and loop (counterparts of ``repro.launch.mesh``,
``train`` and ``loop``)."""
