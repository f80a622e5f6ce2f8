"""The link from a configuration file to the program: for each family,
the port's ``ModelConfig`` built from the file's sizes, and the model
FLOPs a step or a request needs (the numerators of the ``mfu``
shares)."""
