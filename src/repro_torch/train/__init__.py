"""Training of the port (counterpart of ``repro.train``): so far the
data-parallel BFP CNN trainer, ``train.cnn``.  The LM training step and
loop (``repro.train.step`` / ``loop``) arrive with the LM stack."""
