"""Plain BigGAN-deep up to ``generator.gen_z`` (the layout of
``pytorch-pretrained-BigGAN``), float32: the class embedding of a one-hot
class (a linear map without bias), concatenated after z, then the linear
``gen_z`` to 4 x 4 x 16 ch features, as the first latent slot feeds it."""

from __future__ import annotations

from typing import Dict

import torch


class BigGANGenZ:
    def __init__(self, p: Dict[str, torch.Tensor], class_index: int):
        self.embed = p["embeddings.weight"][:, class_index]          # [z_dim]
        self.w = p["generator.gen_z.weight"]                          # [D, 2 z_dim]
        self.b = p["generator.gen_z.bias"]

    def tap(self, z: torch.Tensor, layer: str = "generator.gen_z") -> torch.Tensor:
        if layer != "generator.gen_z":
            raise ValueError(f"the BigGAN reference stops at generator.gen_z, not {layer}")
        cond = torch.cat([z, self.embed[None].expand(z.shape[0], -1)], dim=1)
        return cond @ self.w.T + self.b
