"""Reference-layout alias: `seekr.my_tqdm` -> seekr_tpu_torch (see seekr/my_tqdm.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.utils.progress import my_tqdm, my_trange

__all__ = ['my_tqdm', 'my_trange']

