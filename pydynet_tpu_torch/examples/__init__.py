"""The port's counterparts of ``examples/pydynet``: the tape's gradient
descents (``python -m pydynet_tpu_torch.examples.autograd1d`` and
``autograd2d``), the nn-stack trainers (``dropout_bn``, ``mnist``) and the
recurrent and attention trainers (``ts_prediction``, ``transformer``)."""
