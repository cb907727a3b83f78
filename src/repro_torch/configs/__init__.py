"""LM architecture configs of the port (counterpart of ``repro.configs``):
``base`` (the schema, ``SHAPES``, ``reduced``) and ``registry``
(``ARCHS``, ``get``, ``cells``)."""
