"""Training of the port (counterpart of ``repro.train``): the LM train
step and fault-tolerant loop (``train.step``, ``train.loop``) and the
data-parallel BFP CNN trainer (``train.cnn``)."""
