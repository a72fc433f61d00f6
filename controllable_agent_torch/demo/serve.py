"""Minimal HTTP demo server (mirror of ``controllable_agent_tpu/demo/serve.py``).

Loads a trained run's folder, then serves a form where the user types a
reward equation (e.g. ``vx > 2`` or ``exp(-(x-8)**2) * up``); the agent's
zero-shot z is inferred and a rollout video is returned. stdlib only
(``http.server``):

    python -m controllable_agent_torch.demo.serve folder=/path/to/xp [port=8501] [device=cuda]

``device`` is the card unless ``device=cpu`` is given. A folder trained on
the card keeps its generator's state in the card's format, so serving it
with ``device=cpu`` raises the workspace's ``ValueError`` (load it with the
device type it was saved on). Videos are animated PNGs (``train/video.py``);
``/video?name=rollout.gif`` serves the rollout's.
"""

from __future__ import annotations

import html
import sys
import tempfile
import typing as tp
import urllib.parse
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

_PAGE = """<!DOCTYPE html>
<html><head><title>controllable_agent_torch demo</title></head>
<body style="font-family: sans-serif; max-width: 640px; margin: 2em auto">
<h2>Zero-shot reward demo</h2>
<p>Type a reward equation over {names}. Examples: <code>vx > 2</code>,
<code>exp(-(x-8)**2) * up</code>, <code>-vx</code>.</p>
<form method="get" action="/run">
  <input name="equation" style="width: 70%" value="{equation}"/>
  <button type="submit">Run</button>
</form>
{result}
</body></html>"""
_TYPES = {".png": "image/png", ".gif": "image/gif"}


def _build_engine(folder: str, device: str = "cuda",
                  num_inference_steps: int = 5120) -> tp.Any:
    from ..pretrain import build_workspace
    from ..train.workspace import OfflineWorkspace
    from .core import DemoEngine
    # folder-only arguments: build_workspace restores the run's saved
    # config.json (workspace fields and resolved agent.* keys) as the base,
    # so the checkpoint loads into identically-shaped networks
    ws = build_workspace([f"folder={folder}", f"device={device}"], OfflineWorkspace)
    return DemoEngine(ws, num_inference_steps=num_inference_steps)


class _Handler(BaseHTTPRequestHandler):
    engine: tp.Any = None
    video_dir: Path = Path(tempfile.gettempdir()) / "demo_videos"

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        parsed = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(parsed.query)
        if parsed.path == "/video":
            self._serve_video(qs.get("name", [""])[0])
            return
        equation = qs.get("equation", [""])[0]
        result = ""
        if parsed.path == "/run" and equation:
            try:
                self.video_dir.mkdir(parents=True, exist_ok=True)
                out = self.engine.run(equation, video_path=str(self.video_dir / "rollout.gif"))
                video_html = ""
                if out.get("video"):
                    video_html = '<img src="/video?name=rollout.gif"/>'
                result = (f"<p>reward: {out['reward']:.2f} over "
                          f"{out['steps']} steps</p>{video_html}")
            except ValueError as e:  # whitelist violation
                result = f"<p style='color:red'>{html.escape(str(e))}</p>"
        body = _PAGE.format(names=", ".join(self.engine.feature_names),
                            equation=html.escape(equation), result=result)
        self.send_response(200)
        self.send_header("Content-Type", "text/html")
        self.end_headers()
        self.wfile.write(body.encode())

    def _serve_video(self, name: str) -> None:
        # the recorder writes <name>.png (an animated PNG) for any suffix asked
        base = Path(name).name
        candidates = [d / n for d in (self.video_dir / "eval_video", self.video_dir)
                      for n in (base, str(Path(base).with_suffix(".png")))] if base else []
        path = next((p for p in candidates if p.is_file()), None)
        if path is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", _TYPES.get(path.suffix, "application/octet-stream"))
        self.end_headers()
        self.wfile.write(path.read_bytes())


def make_server(engine: tp.Any, port: int = 8501, host: str = "0.0.0.0",
                video_dir: tp.Optional[tp.Union[str, Path]] = None) -> HTTPServer:
    """An ``HTTPServer`` on (host, port) (port 0: a free one) whose handler
    answers with ``engine`` and keeps videos in ``video_dir``."""
    attrs: tp.Dict[str, tp.Any] = {"engine": engine}
    if video_dir is not None:
        attrs["video_dir"] = Path(video_dir)
    return HTTPServer((host, port), type("DemoHandler", (_Handler,), attrs))


def parse_args(argv: tp.Sequence[str]) -> tp.Tuple[str, int, str]:
    """(folder, port, device) of ``folder=... [port=8501] [device=cuda]``."""
    folder = None
    port = 8501
    device = "cuda"
    for arg in argv:
        if arg.startswith("folder="):
            folder = arg.split("=", 1)[1]
        elif arg.startswith("port="):
            port = int(arg.split("=", 1)[1])
        elif arg.startswith("device="):
            device = arg.split("=", 1)[1]
    if folder is None:
        raise ValueError("usage: ... folder=/path/to/xp [port=8501] [device=cuda]")
    return folder, port, device


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    folder, port, device = parse_args(list(argv if argv is not None else sys.argv[1:]))
    server = make_server(_build_engine(folder, device), port)
    print(f"demo serving on http://0.0.0.0:{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
