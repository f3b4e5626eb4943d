#!/usr/bin/env python
"""Showcase renders for docs/img (veach 640x360x256spp, cornell 512^2x512spp)."""
import dataclasses, os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from monte_carlo_path_tracing_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
import jax
from monte_carlo_path_tracing_tpu.scene import load_scene
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig
from monte_carlo_path_tracing_tpu.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu.render import film

here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
print("devices:", jax.devices(), flush=True)

# veach 640x360 x 256 spp
sc = load_scene(os.path.join(here, "scenes/veach-mis/veach-mis.obj"))
sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=640, height=360))
cfg = RenderConfig(width=640, height=360, spp=256, estimator="mis",
                   light_sampler="spherical_triangle", max_depth=16, seed=0)
r = render_image_regen(sc, cfg, lanes=1<<16)
print(f"veach 640x360x256spp: {r.seconds:.1f}s rays={r.rays_traced/1e6:.0f}M "
      f"({r.rays_traced/r.seconds/1e6:.2f} Mrays/s)", flush=True)
film.write_image(os.path.join(here, "docs/img/veach_mis_640.png"), r.image, 380.0, 0.25)

# cornell 512x512 x 512 spp
sc2 = load_scene(os.path.join(here, "scenes/cornell/cornell.obj"))
sc2 = dataclasses.replace(sc2, camera=dataclasses.replace(sc2.camera, width=512, height=512))
cfg2 = RenderConfig(width=512, height=512, spp=512, estimator="mis",
                    light_sampler="spherical_triangle", max_depth=16, seed=0)
r2 = render_image_regen(sc2, cfg2, lanes=1<<16)
print(f"cornell 512x512x512spp: {r2.seconds:.1f}s rays={r2.rays_traced/1e6:.0f}M "
      f"({r2.rays_traced/r2.seconds/1e6:.2f} Mrays/s)", flush=True)
film.write_image(os.path.join(here, "docs/img/cornell_512.png"), r2.image, 40.0, 0.45)
