"""The port's validation artifacts against the JAX package's on the CPU:
``display_data``'s summary lines, ``make_plot``'s layout, ``write_data``'s
hist.png and .npy series, a validate run's logdir, and the .npy series
where matplotlib does not import."""

import os
import sys

import numpy as np

from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.utils import stats as jstats
from traffic_env_tpu_torch.algorithms import run_alg
from traffic_env_tpu_torch.config import Config
from traffic_env_tpu_torch.utils import stats

SERIES = ([1.0, 2.0, 2.0], [3.0, 4.0, 4.5, 10.0], [5.0])
NAMES = ("light_times", "trip_times", "unfinished")


def test_display_data_summary(capsys):
    """As ``tests/test_components.py`` tests the JAX package's: the
    figure and the mean/mode/std lines, which equal the JAX package's
    lines for the same data."""
    fig = stats.display_data(Config(trainer="greedy"), *SERIES)
    out = capsys.readouterr().out
    assert "Light times mean" in out and "mode 2.0" in out
    assert "Trip times mean" in out and "Unfinished mean" in out
    assert fig is not None
    jstats.display_data(JConfig(trainer="greedy"), *SERIES)
    assert out == capsys.readouterr().out


def layout(fig):
    """The suptitle, and per panel its title, bar heights and the dashed
    mean line's x."""
    panels = [(ax.get_title(), [p.get_height() for p in ax.patches],
               [tuple(l.get_xdata()) for l in ax.lines])
              for ax in fig.axes]
    return fig._suptitle.get_text(), panels


def test_make_plot_is_the_jax_layout():
    import matplotlib.pyplot as plt
    fig = stats.make_plot(Config(trainer="qlearn"), *SERIES)
    jfig = jstats.make_plot(JConfig(trainer="qlearn"), *SERIES)
    try:
        assert layout(fig) == layout(jfig)
        assert layout(fig)[0] == "Stats for qlearn"
        assert [t for t, _, _ in layout(fig)[1]] == [
            "Light Times", "Trip Times", "Unfinished"]
    finally:
        plt.close(fig)
        plt.close(jfig)


def test_write_data_writes_hist_and_series(tmp_path):
    stats.write_data(Config(trainer="qlearn"), *SERIES, outdir=str(tmp_path))
    assert (tmp_path / "hist.png").stat().st_size > 0
    for name, data in zip(NAMES, SERIES):
        np.testing.assert_array_equal(np.load(tmp_path / f"{name}.npy"),
                                      data)


def test_write_data_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Where matplotlib does not import, the .npy series are written and
    one line says that hist.png was not drawn."""
    for mod in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    stats.write_data(Config(trainer="qlearn"), *SERIES, outdir=str(tmp_path))
    assert not (tmp_path / "hist.png").exists()
    for name, data in zip(NAMES, SERIES):
        np.testing.assert_array_equal(np.load(tmp_path / f"{name}.npy"),
                                      data)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].startswith("hist.png not drawn")
    assert stats.display_data(Config(trainer="qlearn"), *SERIES) is None


def test_validate_run_leaves_hist_png(tmp_path):
    """A tiny greedy validate run on the CPU leaves hist.png beside the
    three series in its logdir, as the JAX package's does."""
    logdir = str(tmp_path / "val")
    cfg = Config(trainer="greedy", platform="cpu", mode="validate",
                 num_envs=4, grid_m=2, grid_n=2, episode_secs=20,
                 total_episodes=1, logdir=logdir).derive()
    lights, trips, unfinished = run_alg(cfg)
    assert len(unfinished) == 1
    files = set(os.listdir(logdir))
    assert {"hist.png", "light_times.npy", "trip_times.npy",
            "unfinished.npy"} <= files
    assert os.path.getsize(os.path.join(logdir, "hist.png")) > 0
