"""Training-curve plotting (counterpart of paddle_tpu/utils/plot.py).

Runs without a display: with matplotlib it renders through the Agg
backend, and without it ``plot(path)`` writes the curves to ``path +
'.csv'``, so that no curve is lost."""
import os

__all__ = ['Ploter', 'PlotData']


class PlotData:
    """One curve's (step, value) series."""

    def __init__(self):
        self.step = []
        self.value = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(value)

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    """A plot of several curves:

        ploter = Ploter('train cost', 'test cost')
        ploter.append('train cost', step, loss)
        ploter.plot('curve.png')
    """

    def __init__(self, *args):
        self.__args__ = args
        self.__plot_data__ = {title: PlotData() for title in args}
        self.__disable_plot__ = os.environ.get('DISABLE_PLOT', 'False')

    def __plot_is_disabled__(self):
        return self.__disable_plot__ == 'True'

    def append(self, title, step, value):
        """Add a point to the curve ``title``."""
        if title not in self.__plot_data__:
            raise ValueError(f'{title} is not a curve of this Ploter '
                             f'(curves: {list(self.__plot_data__)})')
        self.__plot_data__[title].append(step, value)

    def plot(self, path=None):
        """Render to ``path``; without matplotlib, write a CSV instead."""
        if self.__plot_is_disabled__():
            return
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
            titles = []
            for title in self.__args__:
                data = self.__plot_data__[title]
                if len(data.step) > 0:
                    titles.append(title)
                    plt.plot(data.step, data.value)
            plt.legend(titles, loc='upper left')
            if path is not None:
                plt.savefig(path)
            plt.clf()
        except ImportError:
            if path is not None:
                with open(str(path) + '.csv', 'w') as f:
                    for title in self.__args__:
                        data = self.__plot_data__[title]
                        for s, v in zip(data.step, data.value):
                            f.write(f'{title},{s},{v}\n')

    def reset(self):
        for data in self.__plot_data__.values():
            data.reset()
