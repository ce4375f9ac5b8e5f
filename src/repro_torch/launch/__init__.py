"""Training entry points of the port: the train step and the ``Trainer``
(``python -m repro_torch.launch.train``)."""
