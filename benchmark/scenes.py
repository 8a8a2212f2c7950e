"""The benchmark's maps, drawn from the seed.

``maps`` replaces the program's ``make_textures`` (a fixed checker and flat
normal maps) by maps drawn from the seed: a noise texture (a texel read from
the wrong place shows) and normal maps that encode random unit vectors.
The meshes come from ``meshes/<generator>.py`` (harness.make_mesh).
"""

from __future__ import annotations

import torch


def maps(size: int, seed: int, device) -> dict:
    """The four (size, size, 3) u8 maps, drawn on `device` from `seed` in a few
    large calls: a noise texture, two normal maps encoding random unit
    vectors ((n / 2 + 0.5) * 255), and a specular map of small exponents."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (size, size, 3)
    texture = torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)
    normals = torch.randn((2, *shape), generator=gen, device=device)
    normals = normals / normals.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    encoded = ((normals * 0.5 + 0.5) * 255.0).round().clamp(0, 255).to(torch.uint8)
    specular = torch.randint(1, 64, (size, size, 1), generator=gen, device=device,
                             dtype=torch.uint8).expand(shape).contiguous()
    return {"texture": texture, "normal_map": encoded[0].contiguous(),
            "normal_map_tangent": encoded[1].contiguous(), "specular_map": specular}
