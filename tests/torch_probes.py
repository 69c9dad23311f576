"""Probes behind the open findings of the examples, run by hand (not a
test module): each prints what it measured.

    python tests/torch_probes.py cone jax|port NUDGE [DEVICE]
        the cone-penetration validation scene (380 clumps), every clump
        moved NUDGE metres in x after Initialize; prints the test's
        forces and corrcoef(depths, forces) (the bound is > 0.5)
    python tests/torch_probes.py cone-batch jax|port [DEVICE] [JOBS]
        the cone run at the 21 nudges k * 4e-8 m, k = -10 .. 10, JOBS
        (4) processes at a time; prints each run's line, then the mean of
        corrcoef and its standard error
    python tests/torch_probes.py cone-welch LOG [LOG ...]
        the corrcoef values of the cone lines in the logs, by package:
        count, mean and standard error of each, and Welch's t-test of
        the two means (two-sided p, and one-sided for port < jax)
    python tests/torch_probes.py cone-st
        one JAX run of that scene taken at four cone depths: the port's
        refresh of each state against JAX's (SS, ST and SA pair sets)
        and the two packages' ST forces on it
    python tests/torch_probes.py flagship jax|port [N] [H]
        both flagship tools (the JAX package's tools/flagship_wheeldp.py
        and the port's) at N clumps (1024) and step H (2e-5) for the
        tools' 0.05 s settle and 0.3 s drive: the wheel's height, the
        bed's top under it, the drawbar and the ST count, 12 times

Run from the repository's root with it on PYTHONPATH and
JAX_PLATFORMS=cpu; the port runs on DEVICE (cpu unless given).
"""

import dataclasses
import functools
import importlib.util
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_file(rel, name):
    import jax

    jax.config.update("jax_platforms", "cpu")
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_example(name, device):
    import torch

    from dem_engine_tpu_torch.examples import load_example

    torch.set_num_threads(2)
    return load_example(name, device)


def cone(which, nudge, device="cpu"):
    c = (_jax_file("examples/cone_penetration.py", "cone") if which == "jax"
         else _port_example("cone_penetration", device))
    s, tracker, speed = c.build(n=380, r=0.005, h=5e-5)
    s.Initialize()
    n = s.GetNumClumps()
    p = s.GetOwnerPosition()[:n].copy()
    p[:, 0] += nudge
    s.SetOwnerPosition(np.arange(n), p)
    s.DoDynamics(0.2)
    curve = c.push(s, tracker, speed=0.3, depth_samples=4, dt_sample=0.035)
    d = np.asarray([x[0] for x in curve])
    f = np.asarray([x[1] for x in curve])
    print(which, nudge, "depths", d.tolist(), "forces", f.tolist(), "corr",
          float(np.corrcoef(d, f)[0, 1]), flush=True)


CONE_NUDGES = [k * 4e-8 for k in range(-10, 11)]


def cone_batch(which, device="cpu", jobs=4):
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    def one(nudge):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "cone", which,
             repr(nudge), device], capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=REPO))
        lines = [ln for ln in out.stdout.splitlines() if " corr " in ln]
        return lines[-1] if lines else (
            f"{which} {nudge} failed: {out.stderr[-400:]}")

    with ThreadPoolExecutor(int(jobs)) as pool:
        lines = list(pool.map(one, CONE_NUDGES))
    for ln in lines:
        print(ln, flush=True)
    corr = np.asarray([float(ln.split(" corr ")[1]) for ln in lines
                       if " corr " in ln])
    print(f"{which}: {len(corr)} runs, mean corr {corr.mean():.4f}, "
          f"standard error {corr.std(ddof=1) / np.sqrt(len(corr)):.4f}, "
          f"{int((corr > 0.5).sum())} above the bound 0.5", flush=True)


def cone_welch(*logs):
    from scipy import stats

    corr = {"jax": [], "port": []}
    for path in logs:
        for ln in open(path):
            head = ln.split()
            if len(head) > 2 and head[0] in corr and " corr " in ln:
                corr[head[0]].append(float(ln.split(" corr ")[1]))
    for k, v in corr.items():
        v = np.asarray(v)
        print(f"{k}: n {len(v)}, mean {v.mean():.4f}, standard error "
              f"{v.std(ddof=1) / np.sqrt(len(v)):.4f}, above 0.5: "
              f"{int((v > 0.5).sum())}")
    t = stats.ttest_ind(corr["port"], corr["jax"], equal_var=False)
    one = stats.ttest_ind(corr["port"], corr["jax"], equal_var=False,
                          alternative="less")
    print(f"Welch: t {t.statistic:.3f}, df {t.df:.1f}, p two-sided "
          f"{t.pvalue:.4f}, p one-sided (port < jax) {one.pvalue:.4f}")


def cone_st():
    import jax

    from dem_engine_tpu.ops import forces as jforces
    from dem_engine_tpu.solver import refresh_contacts as jax_refresh
    from dem_engine_tpu_torch import convert
    from dem_engine_tpu_torch.ops import forces as tforces
    from dem_engine_tpu_torch.solver import refresh_contacts

    jc = _jax_file("examples/cone_penetration.py", "cone")
    tc = _port_example("cone_penetration", "cpu")
    js, jtr, _ = jc.build(n=380, r=0.005, h=5e-5)
    js.Initialize()
    ts, _, _ = tc.build(n=380, r=0.005, h=5e-5)
    ts.Initialize()
    js.DoDynamics(0.2)
    top = js.CreateInspector("clump_max_z").GetValue()
    jtr.SetPos([0.0, 0.0, top + 0.002])
    js.SetFamilyPrescribedLinVel(jc.CONE_FAMILY, 0.0, 0.0, -0.3)
    jcfg = js.engine.cfg
    cfg = dataclasses.replace(
        ts.engine.cfg, cap_ss=jcfg.cap_ss, cap_st=jcfg.cap_st,
        cap_sa=jcfg.cap_sa, max_per_bin=jcfg.max_per_bin,
        max_tri_span=jcfg.max_tri_span)

    def pairs(t):
        a, b = np.asarray(t.idA), np.asarray(t.idB)
        return set(zip(a[a >= 0].tolist(), b[a >= 0].tolist()))

    def by_pair(t):
        a, b, f = np.asarray(t.idA), np.asarray(t.idB), np.asarray(t.force)
        return {(x, y): f[i] for i, (x, y) in enumerate(zip(a, b)) if x >= 0}

    refresh = jax.jit(functools.partial(jax_refresh, cfg=jcfg))
    st_pass = jax.jit(lambda s, p: jforces.contact_pass(
        "st", s.st, s.owners, s.spheres, s.tris, s.anals, p, s.time,
        jcfg.voxel_size, jcfg.force_model,
        krec=jforces.pack_kinematics(s.owners))["table"])
    for _ in range(4):
        js.DoDynamics(0.035 * 2 / 3)
        host = jax.tree_util.tree_map(np.asarray, js.state)
        tstate = convert.state_from_numpy(host, device="cpu", fused_ss=False)
        tparams = convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, js.params), device="cpu")
        j1 = refresh(js.state, js.params)
        t1 = refresh_contacts(tstate, tparams, cfg)
        fj = by_pair(st_pass(j1, js.params))
        ft = by_pair(tforces.contact_pass(
            "st", t1.st, t1.owners, t1.spheres, t1.tris, t1.anals, tparams,
            t1.time, cfg.voxel_size, cfg.force_model)["table"])
        keys = sorted(set(fj) & set(ft))
        ref = np.asarray([fj[k] for k in keys]).reshape(-1, 3)
        got = np.asarray([ft[k] for k in keys]).reshape(-1, 3)
        big = max(float(np.abs(ref).max()) if len(ref) else 0.0, 1e-30)
        print(f"cone z {jtr.Pos()[2]:.5f}: pairs equal SS "
              f"{pairs(j1.ss) == pairs(t1.ss)} ST {pairs(j1.st) == pairs(t1.st)}"
              f" ({len(pairs(j1.st))}) SA {pairs(j1.sa) == pairs(t1.sa)}; ST "
              f"force largest {big:.4g} N, apart "
              f"{float(np.abs(ref - got).max()) / big if len(ref) else 0:.3g}"
              f" of it", flush=True)


def flagship(which, n=1024, h=2e-5, settle=0.05, drive=0.3):
    import tempfile

    out = tempfile.mkdtemp(prefix=f"probe_flagship_{which}_")
    ck = os.path.join(out, "terrain.csv")
    if which == "jax":
        tool = _jax_file("tools/flagship_wheeldp.py", "flagship")
        s, lx, lz = tool.build_prep(n, verbosity="QUIET", h=h)
    else:
        from dem_engine_tpu_torch.tools import flagship_wheeldp as tool

        s, lx, lz = tool.build_prep(n, verbosity="QUIET", h=h, device="cpu")
    s.DoDynamics(settle)
    s.WriteClumpFile(ck)
    if which == "jax":
        s2, tr = tool.restore_and_wheel(ck, lx, lz, verbosity="QUIET", h=h)
    else:
        s2, tr, _, _ = tool.restore_and_wheel(ck, lx, lz, verbosity="QUIET",
                                              h=h, device="cpu")
    for i in range(12):
        s2.DoDynamics(drive / 12)
        _, fs = tr.GetContactForces()
        p = s2.GetOwnerPosition()[:s2.GetNumClumps()]
        near = np.abs(p[:, 0] - tr.Pos()[0]) < 0.12
        print(f"{which} t={(i + 1) * drive / 12:.3f} wheel z="
              f"{tr.Pos()[2]:.4f} bed top under it={p[near, 2].max():.4f} "
              f"drawbar={fs[:, 0].sum() if len(fs) else 0.0:.3f} st="
              f"{int(s2.state.st.count)}", flush=True)


if __name__ == "__main__":
    what, args = sys.argv[1], sys.argv[2:]
    if what == "cone":
        cone(args[0], float(args[1]), *args[2:3])
    elif what == "cone-batch":
        cone_batch(*args)
    elif what == "cone-welch":
        cone_welch(*args)
    elif what == "cone-st":
        cone_st()
    elif what == "flagship":
        flagship(args[0], *[int(args[1])] if len(args) > 1 else [],
                 *[float(args[2])] if len(args) > 2 else [])
    else:
        raise SystemExit(__doc__)
