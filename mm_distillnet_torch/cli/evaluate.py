"""Evaluate a trained student against the teachers' pseudo-ground-truth
(port of the root evaluate.py; reference evaluate.py:51-170):

    python -m mm_distillnet_torch.cli.evaluate --config_file <cfg> \\
        [--checkpoint <ckpt>] [--overwrite JSON] [--rank N] [--device cuda|cpu]

`--checkpoint` is a reference .pth / .pth.tar or the port's own
`checkpoint.{rank}` / `best.{rank}`. The AP table is printed and written
to `{exp_name}/results.{rank}.csv`. Started by torchrun (or with the JAX
package's or the config's world keys), every rank evaluates the whole
split on its own card and writes its own files, as the JAX package's
evaluate() does per process. `--just_plot <frame id>` writes the debug
plots of that frame (utils/plotting.py: attention maps, the student's and
the fused teachers' boxes over each render, one spectrogram image per
microphone) under `{exp_name}/` instead of evaluating.
"""
from __future__ import annotations

import argparse
import logging

from ..config import load_config
from ..data.factory import get_dataset
from ..device import resolve_device
from ..evaluation import evaluate
from ..models.registry import load_model, maybe_load_checkpoint
from ..utils.plotting import plot_audio_predictions
from ..utils.reproducibility import make_reproducible_run
from .train import join_world, load_teachers


def format_table(rows) -> str:
    """The AP table (a list of dicts) as aligned text, one line per row."""
    if not rows:
        return ''
    cols = list(rows[0])
    cells = [[f'{r[c]:.6f}' if isinstance(r[c], float) else str(r[c])
              for c in cols] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells))
              for i, c in enumerate(cols)]
    lines = [' '.join(c.rjust(w) for c, w in zip(cols, widths))]
    lines += [' '.join(v.rjust(w) for v, w in zip(row, widths))
              for row in cells]
    return '\n'.join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Evaluate MM-DistillNet (PyTorch port)')
    parser.add_argument('--config_file', required=True)
    parser.add_argument('--checkpoint', default=None,
                        help='student checkpoint (.pth or the port\'s own)')
    parser.add_argument('--overwrite', default=None)
    parser.add_argument('--rank', type=int, default=None,
                        help="this process's rank (default: the process "
                        "group's, 0 without one)")
    parser.add_argument('--just_plot', default=None,
                        help='plot predictions for one frame id and exit')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    config = load_config(args.config_file, args.overwrite, extra=None
                         if args.rank is None else {'rank': args.rank})
    dev = join_world(config, args.device)
    make_reproducible_run(config.getint('seed', fallback=-1))

    teacher_models = load_teachers(config)
    student_model = load_model(config.get('student'), config,
                               'audio_student')
    if args.checkpoint:
        module, variables = student_model
        student_model = (module, maybe_load_checkpoint(args.checkpoint,
                                                       variables))
    try:
        test_set = get_dataset(config, config.get('eval_split', 'test'))
    except FileNotFoundError:
        test_set = get_dataset(config, 'val')

    if args.just_plot:
        plot_audio_predictions(teacher_models, student_model, test_set,
                               config, args.just_plot, device=dev)
        return None

    ap_table = evaluate(teacher_models, student_model, test_set, config,
                        device=dev)
    print(format_table(ap_table), flush=True)
    return ap_table


if __name__ == '__main__':
    logging.basicConfig(level=logging.WARNING)
    main()
