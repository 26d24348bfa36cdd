"""k-space utilities: uniform meshes and interpolated k-paths.

Functional equivalents of ``tb_model.k_uniform_mesh``
(PythTB 1.8.0 pythtb.py:1792-1861) and ``tb_model.k_path``
(pythtb.py:1863-2026).  Host NumPy -- these produce inputs, they are not
hot.  Output layouts and the path-interpolation scheme (metric from the
periodic lattice rows, near-equidistant node spacing) match the
reference to float64 round-off.
"""

from __future__ import annotations

import numpy as np

__all__ = ["k_uniform_mesh", "k_path"]


def k_uniform_mesh(dim_k: int, mesh_size):
    """Gamma-inclusive uniform mesh, points i/n per periodic direction.

    Returns (prod(mesh), dim_k) float64 in reduced coordinates, with the
    last mesh index varying fastest (C order), as the reference does.
    """
    use_mesh = np.array(list(map(round, mesh_size)), dtype=int)
    if use_mesh.shape != (dim_k,):
        raise ValueError("Incorrect size of the specified k-mesh!")
    if use_mesh.size == 0:
        raise ValueError("Model has no periodic directions; no mesh to make.")
    if np.min(use_mesh) <= 0:
        raise ValueError("Mesh must have positive non-zero number of elements.")
    axes = [np.arange(n, dtype=np.float64) / float(n) for n in use_mesh]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


def k_path(lat, per, dim_k: int, kpts, nk: int, report: bool = True):
    """Interpolate a piecewise-linear path through nodes in reduced coords.

    Returns ``(k_vec (nk, dim_k), k_dist (nk,), k_node (n_nodes,))``.
    Special 1-D strings: 'full' -> [0, .5, 1], 'fullc' -> [-.5, 0, .5],
    'half' -> [0, .5] (pythtb.py:1926-1934).
    """
    if isinstance(kpts, str):
        specials = {
            "full": [[0.0], [0.5], [1.0]],
            "fullc": [[-0.5], [0.0], [0.5]],
            "half": [[0.0], [0.5]],
        }
        if kpts not in specials:
            raise ValueError("Unknown special k-path string: %r" % (kpts,))
        k_list = np.array(specials[kpts])
    else:
        k_list = np.array(kpts, dtype=float)

    if k_list.ndim == 1 and dim_k == 1:
        k_list = k_list[:, None]
    if k_list.shape[1] != dim_k:
        raise ValueError(
            "k-path nodes have dimension %d but dim_k=%d" % (k_list.shape[1], dim_k)
        )
    if nk < k_list.shape[0]:
        raise ValueError("Must have more points in the path than number of nodes.")

    n_nodes = k_list.shape[0]
    lat_per = np.asarray(lat, dtype=float)[list(per)]
    # metric so distances are measured in the Cartesian reciprocal frame
    # with 2*pi absorbed (pythtb.py:1960)
    k_metric = np.linalg.inv(lat_per @ lat_per.T)

    k_node = np.zeros(n_nodes, dtype=float)
    for n in range(1, n_nodes):
        dk = k_list[n] - k_list[n - 1]
        k_node[n] = k_node[n - 1] + np.sqrt(dk @ k_metric @ dk)

    node_index = [0]
    for n in range(1, n_nodes - 1):
        frac = k_node[n] / k_node[-1]
        node_index.append(int(round(frac * (nk - 1))))
    node_index.append(nk - 1)

    k_dist = np.zeros(nk, dtype=float)
    k_vec = np.zeros((nk, dim_k), dtype=float)
    k_vec[0] = k_list[0]
    for n in range(1, n_nodes):
        n_i, n_f = node_index[n - 1], node_index[n]
        if n_f == n_i:
            raise ValueError(
                "k_path: nodes %d and %d map to the same interpolated index "
                "(duplicate node, or segment too short for nk=%d); increase "
                "nk or remove the degenerate node" % (n - 1, n, nk)
            )
        kd_i, kd_f = k_node[n - 1], k_node[n]
        k_i, k_f = k_list[n - 1], k_list[n]
        for j in range(n_i, n_f + 1):
            frac = float(j - n_i) / float(n_f - n_i)
            k_dist[j] = kd_i + frac * (kd_f - kd_i)
            k_vec[j] = k_i + frac * (k_f - k_i)

    if report:
        if dim_k == 1:
            print(" Path in 1D BZ defined by nodes at " + str(k_list.flatten()))
        else:
            print("----- k_path report begin ----------")
            original = np.get_printoptions()
            np.set_printoptions(precision=5)
            print("real-space lattice vectors\n", lat_per)
            print("k-space metric tensor\n", k_metric)
            print("internal coordinates of nodes\n", k_list)
            if lat_per.shape[0] == lat_per.shape[1]:
                lat_per_inv = np.linalg.inv(lat_per).T
                print("reciprocal-space lattice vectors\n", lat_per_inv)
                kpts_cart = np.tensordot(k_list, lat_per_inv, axes=1)
                print("cartesian coordinates of nodes\n", kpts_cart)
            print("list of segments:")
            for n in range(1, n_nodes):
                dk = k_node[n] - k_node[n - 1]
                print(
                    "  length = " + str(round(dk, 5)).rjust(7),
                    " from ", k_list[n - 1], " to ", k_list[n],
                )
            print("node distance list:", k_node)
            print("node index list:   ", np.array(node_index))
            np.set_printoptions(precision=original["precision"])
            print("----- k_path report end ------------")
        print()

    return (k_vec, k_dist, k_node)
