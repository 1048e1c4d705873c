"""repro_torch.launch — meshes over ``torch.distributed``, the training
step factories and loop, the abstract inputs and the serving steps
(counterparts of ``repro.launch.mesh``, ``train``, ``loop``, ``specs``
and ``serve``)."""
