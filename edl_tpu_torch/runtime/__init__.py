"""Training runtime of the port: the optax-default optimizers
(``optim``) and the train-step builders (``trainer``)."""
