"""Plain references, one per configuration (the configuration file names
its module). They are plain PyTorch in float32 with TF32 off, computed in
blocks of batch rows so they fit beside nothing else on the card, and
import nothing of the port."""
