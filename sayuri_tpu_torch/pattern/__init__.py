"""Pattern subsystem (PyTorch port of sayuri_tpu.pattern): spatial pattern
hashing, MM gamma fitting from SGF games, the gammas dictionary and its
policy, and the policy mix into the search's priors.

``pattern.py``, ``mm.py`` and ``gammas.py`` are host-side numpy and pure
Python, copies of the JAX package's; ``gammas_device.py`` computes the
gammas policy of a batch of boards with tensors, for the mix at every
expansion.
"""

from sayuri_tpu_torch.pattern.gammas import GammasDict
from sayuri_tpu_torch.pattern.mm import fit_mm
