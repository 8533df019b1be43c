"""CUDA graph replays over program runs in the window, from the program
cache's counters, in %. Moves images_per_s."""


def read(obs):
    if not obs.get('program_calls'):
        return None
    return 100.0 * obs['replays'] / obs['program_calls']
