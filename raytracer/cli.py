"""Command-line driver (replaces main.rs:49-72 + the compile-time CI env
sniff, main.rs:22-24, with explicit flags).

Usage:
    python -m raytracer render --scene cornell --integrator sppm \
        --width 800 --height 800 --spp 256 --out output/test.png
    python -m raytracer render --scene data/scene_500.json \
        --integrator pt --preset ci
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracer")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render a scene to a PNG")
    r.add_argument("--scene", default="cornell",
                   help="'cornell', 'spheres', 'smoke' (Cornell with "
                        "two smoke volumes), 'field[:N]' (N-sphere "
                        "stress field), 'bunnies[:N]' (N-bunny mesh "
                        "field), 'motion[:N]' (N moving spheres), or a "
                        "data/*.json|yaml path")
    r.add_argument("--integrator", choices=["pt", "sppm"], default="pt",
                   help="path tracer or SPPM (the reference's algorithm)")
    r.add_argument("--width", type=int, default=800)
    r.add_argument("--height", type=int, default=800)
    r.add_argument("--spp", type=int, default=256)
    r.add_argument("--spp-chunk", type=int, default=4)
    r.add_argument("--max-depth", type=int, default=50)
    r.add_argument("--seed", type=int, default=None,
                   help="PRNG seed (default 0; on --resume the checkpoint's "
                        "stored seed wins unless --seed is given explicitly)")
    r.add_argument("--out", default="output/test.png")
    r.add_argument("--preset", choices=["ci"], default=None,
                   help="small CI workload (replaces the reference's "
                        "compile-time CI thread shrink)")
    r.add_argument("--intersector",
                   choices=["auto", "pallas", "xla", "bruteforce", "bvh"],
                   default="auto",
                   help="closest-hit method (ops/dispatch.py); 'pallas' "
                        "is the GPU kernel")
    r.add_argument("--nee", action="store_true",
                   help="next-event estimation for the pt integrator "
                        "(direct-light shadow rays at diffuse vertices; "
                        "same mean, lower variance)")
    r.add_argument("--mis", action="store_true",
                   help="book-3 mixture-PDF importance sampling for the pt "
                        "integrator (50/50 cosine/light-direction mixture "
                        "at diffuse vertices, reweighted by pdf_cos/"
                        "pdf_mix; extension - the reference has no PDF "
                        "classes). Exclusive with --nee")
    r.add_argument("--bvh", action="store_true",
                   help="build a BVH for the scene")
    r.add_argument("--sharded", action="store_true",
                   help="shard over all local devices (parallel layer)")
    # SPPM knobs (reference defaults, photon_mapper.rs:17-19,148-149)
    r.add_argument("--sppm-iters", type=int, default=50)
    r.add_argument("--sppm-photons", type=int, default=500_000)
    r.add_argument("--sppm-alpha", type=float, default=0.7)
    r.add_argument("--checkpoint", default=None,
                   help="write SPPM state here after every iteration")
    r.add_argument("--resume", default=None,
                   help="resume SPPM from a checkpoint file")
    r.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace")
    r.add_argument("--jax-cache", default=None,
                   help="persistent XLA compilation-cache dir (skips "
                        "recompiles on repeat runs; default "
                        "<repo>/output/.jax_cache, and "
                        "JAX_COMPILATION_CACHE_DIR wins when set); '' "
                        "disables")
    r.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans (the sanitizer analog — the "
                        "reference relies on Rust safety + clippy only)")
    return p


def load_scene_arg(name: str, aspect: float):
    if name == "cornell":
        from raytracer.scene.builtin import cornell_box
        return cornell_box(aspect_ratio=aspect)
    if name == "spheres":
        from raytracer.scene.builtin import three_spheres
        return three_spheres(aspect_ratio=aspect)
    if name == "smoke":
        from raytracer.scene.builtin import cornell_smoke
        return cornell_smoke(aspect_ratio=aspect)
    def _count(default: int) -> int:
        if ":" not in name:
            return default
        try:
            n = int(name.split(":", 1)[1])
        except ValueError:
            n = 0
        if n < 1:
            raise SystemExit(
                f"--scene {name!r}: expected a positive integer after ':'")
        return n
    if name == "field" or name.startswith("field:"):
        from raytracer.scene.builtin import sphere_field
        return sphere_field(_count(65536), aspect_ratio=aspect)
    if name == "bunnies" or name.startswith("bunnies:"):
        from raytracer.scene.builtin import bunny_field
        return bunny_field(_count(25), aspect_ratio=aspect)
    if name == "motion" or name.startswith("motion:"):
        from raytracer.scene.builtin import motion_field
        return motion_field(_count(1000), aspect_ratio=aspect)
    from raytracer.scene.loader import load_scene
    return load_scene(name, aspect_ratio=aspect)


def cmd_render(args) -> int:
    import jax
    import numpy as np
    from raytracer.utils.config import RenderConfig, SPPMConfig
    if getattr(args, "debug_nans", False):
        jax.config.update("jax_debug_nans", True)
    if args.jax_cache != "":
        from raytracer.utils import compile_cache
        compile_cache.enable(args.jax_cache)
    from raytracer.utils.image import save_render
    from raytracer.utils.timing import StageTimer, maybe_profile

    timer = StageTimer()
    cfg = RenderConfig(
        width=args.width, height=args.height, samples_per_pixel=args.spp,
        spp_chunk=args.spp_chunk, max_depth=args.max_depth,
        seed=args.seed if args.seed is not None else 0,
        intersector=args.intersector, output=args.out,
        nee=args.nee, mis=args.mis,
        sppm=SPPMConfig(n_iterations=args.sppm_iters,
                        photons_per_iter=args.sppm_photons,
                        alpha=args.sppm_alpha))
    if args.preset == "ci":
        ci = RenderConfig.ci_preset()
        cfg = cfg.replace(width=ci.width, height=ci.height,
                          samples_per_pixel=ci.samples_per_pixel,
                          max_depth=ci.max_depth, sppm=ci.sppm)

    with timer.stage("Scene build"):
        scene = load_scene_arg(args.scene, cfg.width / cfg.height)
        if args.bvh or args.intersector == "bvh":
            from raytracer.ops.bvh import build_bvh
            scene = build_bvh(scene)
    key = jax.random.PRNGKey(cfg.seed)

    with maybe_profile(args.profile_dir):
        if args.integrator == "sppm":
            from raytracer.models import sppm
            from raytracer.utils import checkpoint as ckpt
            state = None
            if args.resume:
                # the stored seed reproduces the original key stream (the
                # bit-tight resume equivalence only holds when seeds match);
                # an explicit --seed overrides it, with a warning.
                state, stored_seed = ckpt.load_state(args.resume)
                if args.seed is None:
                    cfg = cfg.replace(seed=stored_seed)
                    key = jax.random.PRNGKey(cfg.seed)
                elif args.seed != stored_seed:
                    print(f"warning: --seed {args.seed} != checkpoint seed "
                          f"{stored_seed}; resumed render will not match the "
                          "original", file=sys.stderr)
                print(f"resumed from {args.resume} at iteration "
                      f"{int(state.iteration)}")
            cb = None
            if args.checkpoint:
                cb = lambda s: ckpt.save_state(args.checkpoint, s, cfg.seed)
            with timer.stage("SPPM"):
                if args.sharded:
                    from raytracer.parallel.sppm import render_sppm
                    img, rays, state = render_sppm(scene, cfg, key,
                                                   state=state,
                                                   checkpoint_cb=cb)
                else:
                    img, rays, state = sppm.render(scene, cfg, key,
                                                   state=state,
                                                   checkpoint_cb=cb)
        else:
            with timer.stage("RT"):
                if args.sharded:
                    from raytracer.parallel import render as prender
                    img, rays = prender.render(scene, cfg, key)
                else:
                    from raytracer.models import path_tracer
                    img, rays = path_tracer.render(scene, cfg, key)
        img = np.asarray(jax.block_until_ready(img))

    timer.count("traced_rays", int(rays))
    with timer.stage("Save"):
        save_render(cfg.output, img)
    print(timer.summary())
    print(f"wrote {cfg.output}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "render":
        return cmd_render(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
