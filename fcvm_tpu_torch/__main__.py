"""Command-line front end: ``python -m fcvm_tpu_torch <command> case.toml``.

The port of :mod:`fcvm_tpu.__main__`, the batch equivalent of the reference
workbench's Start / Save / Sum buttons (``InitGui.py:141-145``):

  run     full collapse analysis -> .out, .vtk, .png (the Start button)
  buckle  linear buckling factors + mode shapes
  info    parse + validate a case, print the model summary
  bench   quick per-step timing of the case on the current device
  sum     post-hoc surface/edge averages from a finished run's .vtk
          (the Sum button; reads [[sum.*]] groups from the case file)

The analysis runs on the GPU (``FcvmConfig(device="cuda")``), and raises
when there is none, unless ``--cpu`` asks for the CPU; ``--x64`` runs it in
float64; ``--no-plots`` skips the matplotlib outputs of ``run`` (beyond
the JAX package's CLI, for machines without matplotlib).  A FreeCAD
``.FCStd`` document runs with its paired ``.inp`` control file
(:func:`fcvm_tpu_torch.models.fcstd.load_reference_case`; ``--inp`` and
``--mesh`` replace the paired file and the embedded mesh): ``run`` writes
no ``.avr`` for it and ``sum`` refuses it (both need a TOML case's
``[[sum.*]]`` groups).

Several devices run the sharded backend (:mod:`fcvm_tpu_torch.parallel`),
one process per device.  ``--devices N`` (N > 1) starts N local ranks
itself: one per visible GPU (more ranks than GPUs raise), or N gloo ranks
on the CPU with ``--cpu``.  ``--distributed`` joins a launch made outside:
``torchrun --nproc-per-node N -m fcvm_tpu_torch run case.toml
--distributed`` (``env://``), or the same command on every process with
``--coordinator HOST:PORT --num-processes N --process-id R`` (``tcp://``);
the world size is the device count.  Every rank solves; rank 0 alone
prints and writes files.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fcvm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("run", "buckle", "info", "bench", "sum"):
        p = sub.add_parser(name)
        p.add_argument("case", help="TOML case file or FreeCAD .FCStd document")
        p.add_argument("--inp", default=None,
                       help=".inp control file overriding the document's paired one "
                       "(FCStd input only)")
        p.add_argument("--mesh", default=None,
                       help="external mesh file (UNV/Gmsh/VTK) replacing the "
                       "document's embedded mesh (FCStd input only)")
        p.add_argument("--outdir", default="out")
        p.add_argument("--x64", action="store_true", help="run in float64")
        p.add_argument("--cpu", action="store_true", help="run on the CPU, not the GPU")
        p.add_argument("--checkpoint", action="store_true",
                       help="save every converged step under OUTDIR/checkpoints")
        p.add_argument("--resume", default=None, metavar="DIR",
                       help="resume from the latest step checkpoint in DIR "
                       "(written by a previous --checkpoint run)")
        p.add_argument("--steps", type=int, default=0, help="override nstep")
        p.add_argument("--devices", type=int, default=0,
                       help="number of devices: N > 1 starts N ranks of the sharded "
                       "backend, one per GPU (gloo ranks on the CPU with --cpu)")
        p.add_argument("--gif", action="store_true", help="also write the orbital clip-view GIF")
        p.add_argument("--no-plots", action="store_true",
                       help="run: skip the .png curves and viewer bundle (which need "
                       "matplotlib)")
        p.add_argument("--distributed", action="store_true",
                       help="join a multi-process launch (torchrun's env://, or "
                       "--coordinator): one rank per device, the world size is the "
                       "device count")
        p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                       help="with --distributed: rank 0's address (tcp://), with "
                       "--num-processes and --process-id")
        p.add_argument("--num-processes", type=int, default=None)
        p.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    launch = (args.coordinator, args.num_processes, args.process_id)
    if not args.distributed and launch != (None, None, None):
        ap.error("--coordinator/--num-processes/--process-id need --distributed")
    if args.coordinator is not None and None in launch:
        ap.error("--coordinator needs --num-processes and --process-id")

    from fcvm_tpu_torch.parallel import dist as pdist

    device = "cpu" if args.cpu else "cuda"
    if args.distributed:
        pdist.init_process_group(
            device, init_method=f"tcp://{args.coordinator}" if args.coordinator else "env://",
            world_size=args.num_processes, rank=args.process_id)
        try:
            return _command(args)
        finally:
            pdist.destroy_process_group()
    if args.devices > 1 and args.cmd in ("run", "buckle", "bench"):
        if not args.cpu:
            import torch

            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if args.devices > found:
                raise RuntimeError(f"--devices {args.devices}: found {found} CUDA device(s)")
        import importlib

        # by module name: a spawned process does not import a package's
        # __main__ as its own, so `__main__._command` would not unpickle
        rank_command = importlib.import_module("fcvm_tpu_torch.__main__")._command
        return max(pdist.spawn(rank_command, args.devices, args=(args,), device=device))
    return _command(args)


def _command(args) -> int:
    """Run ``args.cmd`` in this process: one rank of a multi-device run, or
    the only process."""
    from fcvm_tpu_torch.parallel import dist as pdist

    say = print if pdist.rank() == 0 else (lambda *a, **k: None)
    fcstd = str(args.case).lower().endswith(".fcstd")

    from fcvm_tpu_torch.config import FcvmConfig
    from fcvm_tpu_torch.models.casefile import load_case, parse_sum_groups

    cfg = FcvmConfig(device="cpu" if args.cpu else "cuda",
                     dtype="float64" if args.x64 else "float32",
                     n_devices=args.devices or pdist.world_size())
    cfg.check_supported()
    if fcstd:
        # FreeCAD document + its paired .inp control file, the reference's
        # own input pairing (fcVM.py:74-76)
        from fcvm_tpu_torch.models.fcstd import load_reference_case

        model, params = load_reference_case(args.case, inp_path=args.inp, mesh_path=args.mesh)
    else:
        model, params = load_case(args.case)
    if args.steps:
        params.nstep = args.steps

    if args.cmd == "info":
        m = model.mesh
        fixmask, u_fix, movdof = model.bcs.masks(m.ndof)
        say(f"model: {model.name}")
        say(f"nodes: {m.n_nodes}  elements: {m.n_elements}  ndof: {m.ndof}")
        say(f"material: E={model.material.e} nu={model.material.nu} "
              f"rho={model.material.density}")
        say(f"fixed dofs: {int((fixmask < 0.5).sum())}  "
              f"driven dofs: {int(movdof.sum())}")
        say(f"loads: {len(model.loads.pressure_faces)} pressure faces, "
              f"{len(model.loads.traction_faces)} traction faces, "
              f"{len(model.loads.vertices)} point loads, "
              f"gravity {model.loads.gravity.tolist()}")
        say(f"control: nstep={params.nstep} gnl={params.gnl} "
              f"sig_yield={params.sig_yield} target_LF={params.target_lf}")
        return 0

    if args.cmd == "sum":
        if pdist.rank() != 0:
            return 0  # host work on the finished run's files: rank 0's
        # Post-hoc Sum (fcVM_sum.FCMacro): the reference reads CSR/PEEQ/
        # von Mises from the stored result object of a finished analysis;
        # here they are read back from the run's exported .vtk (host only).
        from pathlib import Path

        from fcvm_tpu_torch.models.meshio_io import read_vtk
        from fcvm_tpu_torch.ops import postproc
        from fcvm_tpu_torch.runtime import report as report_mod
        from fcvm_tpu_torch.runtime.vtk import read_point_fields

        if fcstd:
            print("sum needs a TOML case file with [[sum.edge]]/[[sum.face]] groups",
                  file=sys.stderr)
            return 2
        edge_groups, face_groups = parse_sum_groups(args.case, model.mesh)
        if not (edge_groups or face_groups):
            print("no [[sum.edge]]/[[sum.face]] groups in the case file", file=sys.stderr)
            return 2
        vtk_path = Path(args.outdir) / f"{model.name}.vtk"
        if not vtk_path.exists():
            print(f"{vtk_path} not found — run the analysis first", file=sys.stderr)
            return 2
        fields = read_point_fields(vtk_path)
        peeq = fields["Equivalent_Plastic_Strain"]
        csr = fields["Critical_Strain_Ratio"]
        svm = fields["von_Mises_Stress"]
        coords = read_vtk(vtk_path).coords  # run-time (possibly seeded) coords
        e_names, f_names = list(edge_groups), list(face_groups)
        e_len, (e_peeq, e_csr, e_svm) = postproc.integrate_edges(
            [edge_groups[k] for k in e_names], coords, peeq, csr, svm)
        f_area, (f_peeq, f_csr, f_svm) = postproc.integrate_faces(
            [face_groups[k] for k in f_names], coords, peeq, csr, svm)
        report_mod.write_avr(
            vtk_path.with_suffix(".avr"), model.name,
            e_names, e_len, e_peeq, e_csr, e_svm,
            f_names, f_area, f_peeq, f_csr, f_svm,
        )
        print(f"wrote {vtk_path.with_suffix('.avr')}")
        return 0

    cfg.resolve_device()  # raises when the GPU was asked for and there is none
    import fcvm_tpu_torch

    if args.cmd == "buckle":
        lam, vecs = fcvm_tpu_torch.linear_buckling(model, params, k=2, config=cfg)
        say("buckling load factors:", lam)
        return 0

    if args.cmd == "run":
        res = fcvm_tpu_torch.run_analysis(
            model, params, outdir=args.outdir,
            checkpoint=args.checkpoint, resume_from=args.resume,
            progress=say, save_plots=not args.no_plots, config=cfg,
        )
        h = res.history
        say(f"final load level: {h.lbd[-1]:.5f}  max |u|: {max(h.un):.5e}  "
              f"PEEQ max: {h.peeqmax[-1]:.4e}  CSR max: {h.csr[-1]:.4e}")
        if args.gif and pdist.rank() == 0:
            from fcvm_tpu_torch.ops import postproc
            from fcvm_tpu_torch.runtime.viz import save_orbit_gif
            from fcvm_tpu_torch.runtime.vtk import _elements_per_node

            noce = _elements_per_node(model.mesh.elnodes, model.mesh.n_nodes)
            _, _, csr_n, _, _ = postproc.map_stresses(
                params.averaged_option == "averaged", model.mesh.elnodes,
                model.mesh.n_nodes, res.sig_gp, res.peeq_gp, res.csr_gp,
                res.svm_gp, noce, params.sig_yield,
            )
            save_orbit_gif(f"{args.outdir}/{model.name}_orbit.gif", res.coords,
                           model.mesh.elnodes, csr_n)
        say(f"wrote {args.outdir}/{model.name}.out .vtk" + ("" if args.no_plots else " .png"))
        edge_groups, face_groups = ({}, {}) if fcstd else parse_sum_groups(args.case,
                                                                            model.mesh)
        if (edge_groups or face_groups) and pdist.rank() == 0:
            fcvm_tpu_torch.run_sum(model, res, params, edge_groups, face_groups,
                                   outdir=args.outdir)
            say(f"wrote {args.outdir}/{model.name}.avr")
        return 0

    if args.cmd == "bench":
        t0 = time.time()
        res = fcvm_tpu_torch.solve_collapse(model, params, config=cfg)
        dt = time.time() - t0
        nsteps = max(len(res.history.lbd) - 1, 1)
        say(json.dumps({
            "metric": "case_step_wall_ms",
            "value": round(dt / nsteps * 1e3, 2),
            "unit": "ms",
            "steps": nsteps,
            "cg_solves": res.cg_stats["solves"],
            "cg_iters": res.cg_stats["iters"],
        }))
        return 0


if __name__ == "__main__":
    sys.exit(main())
