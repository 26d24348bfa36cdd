"""Model zoo: ready-made tight-binding models (counterpart of
``pythtb_tpu.models``).

Canonical models from the tight-binding / band-topology literature,
parameterized and documented.  Every constructor returns a fresh
:class:`pythtb_tpu_torch.tb_model` that can be further edited, cut,
super-celled, etc.  ``moire`` builds commensurate twisted bilayer
graphene, ``quasicrystal`` the Penrose / Ammann-Beenker vertex models and
the Aubry-Andre and Fibonacci chains.
"""

from .moire import sk_graphene, tbg, tbg_angle
from .quasicrystal import (
    ammann_beenker,
    aubry_andre,
    fibonacci_chain,
    fibonacci_word,
    multigrid_tiling,
    penrose,
    vertex_areas,
)
from .library import (
    apply_strain,
    bbh,
    bhz,
    bn,
    chain,
    checkerboard,
    cscl,
    fu_kane_mele,
    graphene,
    haldane,
    kagome,
    kane_mele,
    lieb,
    molecule_nh3,
    qwz,
    square,
    ssh,
    three_site_chain,
    trestle,
    triaxial_graphene_flake,
    weyl,
)

__all__ = [
    "chain",
    "molecule_nh3",
    "trestle",
    "checkerboard",
    "graphene",
    "bn",
    "haldane",
    "qwz",
    "kane_mele",
    "three_site_chain",
    "cscl",
    "fu_kane_mele",
    "square",
    "ssh",
    "lieb",
    "kagome",
    "bhz",
    "bbh",
    "weyl",
    "tbg",
    "tbg_angle",
    "sk_graphene",
    "apply_strain",
    "triaxial_graphene_flake",
    "multigrid_tiling",
    "penrose",
    "ammann_beenker",
    "aubry_andre",
    "fibonacci_chain",
    "fibonacci_word",
    "vertex_areas",
]
