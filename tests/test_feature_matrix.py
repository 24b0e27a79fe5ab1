"""Feature-matrix end-to-end smoke runs (tests/only_HMF_tests analog):
every compile-flag configuration of the reference's test matrix must run
end-to-end and produce a consistent halo population at 64^3."""

import dataclasses

import pytest


# the full 6-configuration matrix of the reference's
# tests/only_HMF_tests (SURVEY.md §4.3)
@pytest.mark.parametrize("name,over", [
    ("SCALE_DEP_LCDM", dict(scale_dependent=True, FixedIC=True)),
    ("RECOMPUTE_DISPLACEMENTS_LCDM", dict(recompute_displacements=True)),
    ("RECOMPUTE_and_SCALE_DEP", dict(recompute_displacements=True,
                                     scale_dependent=True)),
    ("READ_PK_TABLE_and_SCALE_DEP", dict(scale_dependent=True,
                                         camb=True)),
    ("MOD_GRAV_and_SCALE_DEP", dict(mod_grav_fr=True, fr0=1e-7,
                                    scale_dependent=True)),
    ("MOD_GRAV_and_SCALE_DEP_and_RECOMPUTE",
     dict(mod_grav_fr=True, fr0=1e-7, scale_dependent=True,
          recompute_displacements=True)),
])
def test_feature_config_runs(hmf_validation_params, name, over, request):
    from pinocchio_jax.run import run_pipeline
    over = dict(over)
    if over.pop("camb", False):
        # the table set of the LCDM cosmology (scripts/make_camb_inputs.py)
        over.update(request.getfixturevalue("camb_tables"))
    p = dataclasses.replace(hmf_validation_params, GridSize=64, **over)
    res = run_pipeline(p, verbose=False, write_outputs=False)
    snap = res["frag"].catalogs[-1]
    nh = int((snap.mass >= p.MinHaloMass).sum())
    # 64^3 of this box forms ~1.2k halos; any config must stay in family
    assert 900 < nh < 1600, (name, nh)
    # mass conservation within the stored set
    g = res["frag"].groups
    in_halos = int(g.mass[2:][g.alive[2:] > 0].sum())
    assert in_halos + int(g.mass[1]) == res["frag"].nstored
