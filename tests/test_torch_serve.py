"""The port's demo server (``controllable_agent_torch/demo/serve.py``) on the
CPU: the real ``HTTPServer`` on a free port in a thread, answering
``/run``, a rejected injection, ``/video`` (200 and 404), over a small run's
folder; the parsing of ``folder=``, ``port=`` and ``device=``; a folder whose
generator was saved on the card, served with ``device=cpu``."""

import threading
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from controllable_agent_torch.demo import serve
from torch_small_run import small_run


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    run = tmp_path_factory.mktemp("serve") / "run"
    small_run(run)
    return run


@pytest.fixture(scope="module")
def server(folder, tmp_path_factory):
    engine = serve._build_engine(str(folder), "cpu", num_inference_steps=64)
    httpd = serve.make_server(engine, 0, "127.0.0.1", tmp_path_factory.mktemp("videos"))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _get(url: str):
    with urllib.request.urlopen(url, timeout=120) as response:
        return response.status, response.headers.get("Content-Type"), response.read()


def test_run_answers_with_reward_and_video(server) -> None:
    status, kind, body = _get(f"{server}/run?equation=" + urllib.parse.quote("vx > 0.5"))
    page = body.decode()
    assert status == 200 and kind == "text/html"
    assert "reward: " in page and " steps</p>" in page
    assert '<img src="/video?name=rollout.gif"/>' in page
    assert "x, z, up, vx, vz, am" in page  # the walker's feature names


def test_injection_is_shown_in_red(server) -> None:
    status, _, body = _get(f"{server}/run?equation=" + urllib.parse.quote("__import__('os')"))
    page = body.decode()
    assert status == 200
    assert "<p style='color:red'>" in page and "not allowed" in page
    assert "reward: " not in page


def test_video_is_served(server) -> None:
    _get(f"{server}/run?equation=up")
    status, kind, body = _get(f"{server}/video?name=rollout.gif")
    assert status == 200 and kind == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n" and b"acTL" in body  # an animated PNG
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(f"{server}/video?name=missing.gif")
    assert err.value.code == 404


def test_page_without_equation(server) -> None:
    status, _, body = _get(f"{server}/")
    assert status == 200 and "<form" in body.decode() and "reward: " not in body.decode()


def test_parse_args() -> None:
    assert serve.parse_args(["folder=/x/y"]) == ("/x/y", 8501, "cuda")
    assert serve.parse_args(["port=9000", "folder=f", "device=cpu"]) == ("f", 9000, "cpu")
    with pytest.raises(ValueError, match="usage"):
        serve.parse_args(["port=9000"])


def test_main_needs_a_card_unless_told(folder) -> None:
    """``device`` defaults to the card: without one the server does not start
    on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([f"folder={folder}", "port=0"])


def test_card_folder_on_the_cpu_raises(folder, tmp_path) -> None:
    """A folder whose generator state was saved on the card (a CUDA
    generator's state, 16 bytes) served with ``device=cpu``: the workspace's
    clear ``ValueError``."""
    import shutil
    copy = tmp_path / "card_run"
    shutil.copytree(folder, copy)
    agent_pt = copy / "models" / "latest" / "agent.pt"
    state = torch.load(agent_pt, weights_only=True)
    state["generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(state, agent_pt)
    with pytest.raises(ValueError, match="another device type"):
        serve._build_engine(str(copy), "cpu")
