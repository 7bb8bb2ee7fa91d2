"""The plain reference: the multimodal VAE, its training steps and the DAA
written from their equations in plain PyTorch and NumPy. It imports
nothing of the program under test and takes nothing the program computed;
it reads the program's outputs only to judge them (``compare``)."""
