"""Training-curve plotting (reference python/paddle/v2/plot/plot.py Ploter —
the v2 notebook workflow's live loss/metric curves).

Same API: `Ploter("train cost", "test cost")`, `append(title, step, value)`,
`plot(path=None)`, `reset()`. Differences by design:

- headless-first: with DISABLE_PLOT=True (or no matplotlib) the plot() call
  degrades to a one-line text summary per series instead of crashing, so
  event handlers are portable between notebooks and batch jobs on a card;
- series data is exposed (`data(title)` -> (steps, values)) for tests and
  for exporting curves to the profiler/metrics pipeline.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

__all__ = ["PlotData", "Ploter"]


class PlotData:
    def __init__(self):
        self.step: List[int] = []
        self.value: List[float] = []

    def append(self, step: int, value: float) -> None:
        self.step.append(step)
        self.value.append(value)

    def reset(self) -> None:
        self.step = []
        self.value = []


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
        return True
    except ImportError:
        return False


def _plotting_disabled() -> bool:
    return os.environ.get("DISABLE_PLOT") == "True" or not _have_matplotlib()


class Ploter:
    def __init__(self, *titles: str):
        self._titles = titles
        self._series: Dict[str, PlotData] = {t: PlotData() for t in titles}

    def append(self, title: str, step: int, value: float) -> None:
        if title not in self._series:
            raise KeyError(f"unknown series '{title}' — declared: "
                           f"{list(self._titles)}")
        self._series[title].append(step, float(value))

    def data(self, title: str) -> Tuple[List[int], List[float]]:
        d = self._series[title]
        return d.step, d.value

    def plot(self, path: Optional[str] = None) -> None:
        # an explicit path means "write the file": only a genuinely missing
        # matplotlib prevents that (Agg needs no display, so DISABLE_PLOT
        # only suppresses the interactive/no-path mode)
        if _plotting_disabled() and (path is None or not _have_matplotlib()):
            if path is not None:
                print(f"[plot] matplotlib unavailable — NOT writing {path}")
            for t in self._titles:
                d = self._series[t]
                if d.step:
                    print(f"[plot] {t}: step {d.step[-1]} "
                          f"value {d.value[-1]:.6g} ({len(d.step)} points)")
            return
        if path is not None:
            # File output renders through an explicit Agg canvas, bypassing
            # the process-global backend entirely — a pyplot import earlier
            # in the process (with any backend) can't break savefig.
            from matplotlib.backends.backend_agg import FigureCanvasAgg
            from matplotlib.figure import Figure

            fig = Figure()
            FigureCanvasAgg(fig)
            self._draw(fig.add_subplot(111))
            fig.savefig(path)
            return
        import matplotlib.pyplot as plt

        self._draw(plt)
        try:
            from IPython import display
            display.clear_output(wait=True)
            display.display(plt.gcf())
        except ImportError:
            plt.show()
        plt.gcf().clear()

    def _draw(self, ax) -> None:
        """Plot all non-empty series onto `ax` (an Axes or the pyplot
        module — both expose plot/legend)."""
        drawn = []
        for t in self._titles:
            d = self._series[t]
            if d.step:
                ax.plot(d.step, d.value)
                drawn.append(t)
        ax.legend(drawn, loc="upper left")

    def reset(self) -> None:
        for d in self._series.values():
            d.reset()
