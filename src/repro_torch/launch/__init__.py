"""Entry points of the port: ``serve`` (the serving CLI) and ``train``
(the training driver)."""
