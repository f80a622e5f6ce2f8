"""The model serving path of the port: parameters, layers, the Mamba-2
SSD mixer and the decoder stack (``models/`` of the reference)."""
