"""The port's counterparts of ``examples/pydynet``: the nn-stack trainers
(``python -m pydynet_tpu_torch.examples.dropout_bn`` and
``python -m pydynet_tpu_torch.examples.mnist``)."""
