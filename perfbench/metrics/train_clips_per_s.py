"""Clips in every training step completed in the window over the window's
seconds; the window closes when the card has finished the last step
enqueued before its end."""


def read(run):
    return run.window["clips"] / run.window["seconds"]
