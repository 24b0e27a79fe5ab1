#!/usr/bin/env python
"""3-D visualization of the past-light-cone box tiling.

Analog of the reference's scripts/PlcGeometryplot_3D.py: parses a
pinocchio.<run>.geometry.out file (written by pinocchio_jax.plc) and
draws every box replication that intersects the cone, the cone axis,
and the aperture, saving a PNG next to the input.

Usage:  python scripts/plc_geometry_plot.py pinocchio.run.geometry.out
"""

import argparse
import os
import sys

import numpy as np


def parse_geometry(path):
    """Header keys + replication rows of a .geometry.out file."""
    meta, rows = {}, []
    with open(path) as fd:
        for line in fd:
            if line.startswith("#"):
                parts = line[1:].split("=")
                if len(parts) == 2:
                    meta[parts[0].strip()] = [float(x)
                                              for x in parts[1].split()]
                elif "replications" in line:
                    meta["nrepl"] = int(line.split(":")[1])
                elif "distance range" in line:
                    meta["range"] = [float(x)
                                     for x in line.split(":")[1].split()]
            elif line.strip():
                v = line.split()
                rows.append((int(v[0]), int(v[1]), int(v[2]), int(v[3]),
                             float(v[4]), float(v[5]), int(v[6]),
                             int(v[7])))
    return meta, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("geometry_file")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; printing the parsed geometry only")
        meta, rows = parse_geometry(args.geometry_file)
        print(meta)
        for r in rows:
            print(r)
        return 0

    meta, rows = parse_geometry(args.geometry_file)
    L = meta["L"][0]
    V = np.array(meta["V"])
    D = np.array(meta["D"])
    rmax = meta["range"][1]

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")

    # one wireframe cube per replication (grid units)
    edges = [(0, 1), (1, 3), (3, 2), (2, 0), (4, 5), (5, 7), (7, 6),
             (6, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)], float)
    for _, i, j, k, F1, F2, *_ in rows:
        o = np.array([i, j, k], float) * L
        for a, b in edges:
            p, q = o + corners[a] * L, o + corners[b] * L
            ax.plot(*zip(p, q), color="steelblue", lw=0.5, alpha=0.5)

    # cone axis from the vertex out to the largest distance
    ax.plot(*zip(V, V + D * rmax), color="crimson", lw=2, label="cone axis")
    ax.scatter(*V, color="crimson", s=30)
    aperture = meta["A"][0]

    # a few cone generatrices at the aperture angle
    ref = np.array([1.0, 0.0, 0.0])
    if abs(np.dot(ref, D)) > 0.9:
        ref = np.array([0.0, 1.0, 0.0])
    e1 = np.cross(D, ref)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(D, e1)
    th = np.radians(min(aperture, 90.0))
    for phi in np.linspace(0, 2 * np.pi, 16, endpoint=False):
        g = (np.cos(th) * D
             + np.sin(th) * (np.cos(phi) * e1 + np.sin(phi) * e2))
        ax.plot(*zip(V, V + g * rmax), color="orange", lw=0.5, alpha=0.7)

    ax.set_title(f"{len(rows)} replications, aperture {aperture:.1f} deg, "
                 f"r <= {rmax:.1f} (grid units)")
    ax.legend()
    out = args.output or args.geometry_file.rsplit(".", 1)[0] + ".png"
    fig.savefig(out, dpi=120)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
