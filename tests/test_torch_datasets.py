"""The port's real datasets (mm_distillnet_torch/data/{multimodal,flir,
argoverse,cityscapes,factory}.py) against the JAX package's on fixture
trees in each dataset's layout, written here with cv2 at small sizes.

Tolerances (tests/test_torch_transforms.py has the reasons): decoding,
cropping, the thermal clip and min-max, the colour map, labels and ids are
exact; the float resizes agree within REL = 1e-5 of each array's range;
FLIR's RGB is resized as uint8 (within 1 LSB of cv2), so after /255 and
the ImageNet normalisation its rgb agrees within FLIR_RGB_ATOL. The mel
spectrogram of merge_audios agrees within the frontend's MEL_RTOL (1e-4)
and the bicubic stretch's REL.

Also: the 8-bit-thermal OverflowError on both sides, merge_audios and
yield_batch under a seed, get_dataset for every name, refine_ids'
prediction route (the CSV cache and the 0.40 cut), and the train CLI on
the shipped config with its own dataset on a Freiburg tree at the
test-tiny profile, its student scored by the evaluate CLIs of both
packages on that tree.
"""
import csv
import json
import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from mm_distillnet_tpu.config import default_config as jax_default_config
from mm_distillnet_tpu.config import load_config as jax_load_config
from mm_distillnet_tpu.data import argoverse as jax_argoverse
from mm_distillnet_tpu.data import cityscapes as jax_cityscapes
from mm_distillnet_tpu.data import factory as jax_factory
from mm_distillnet_tpu.data import flir as jax_flir
from mm_distillnet_tpu.data import multimodal as jax_multimodal
from mm_distillnet_tpu.data.synthetic import \
    SyntheticMultimodal as JaxSynthetic
from mm_distillnet_tpu.models import registry as jax_registry
from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.train import trainer as jax_trainer
from mm_distillnet_torch.cli import evaluate as cli_evaluate
from mm_distillnet_torch.cli import train as cli_train
from mm_distillnet_torch.config import default_config, load_config
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.data import argoverse, cityscapes, factory, flir
from mm_distillnet_torch.data import multimodal
from mm_distillnet_torch.data.synthetic import SyntheticMultimodal
from mm_distillnet_torch.models.efficientdet import EfficientDet

from .test_torch_cli import (CHANNELS, COLUMNS, CONFIG, TINY, _fast_jax_init,
                             _import_root, _read_csv, _write_pth)
from .test_torch_evaluation import PARITY_ATOL
from .test_torch_helpers import filled_variables, nhwc_input
from .test_torch_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the tree writer of its data phase)

REL = 1e-5
MEL_RTOL = 1e-4
FLIR_RGB_ATOL = 1.0 / 255 / 0.224 + 1e-5   # 1 LSB through the ImageNet std
SIZE = 64


def assert_close(got, want, rel=REL, atol=0.0):
    assert got.shape == want.shape, (got.shape, want.shape)
    span = float(np.ptp(want)) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * span + atol)


def assert_samples_close(got, want, atol=None):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v is None or isinstance(v, str):
            assert got[k] == v, k
        elif k == 'label':
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k].dtype == v.dtype, k
            assert_close(got[k], v, atol=(atol or {}).get(k, 0.0))


def textured(shape, seed, hi=256, dtype=np.uint8, lo=0):
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = lo + (np.sin(xx / 7.0) * np.cos(yy / 5.0) + 1) * (hi - lo) / 3
    img = base.reshape(h, w, *([1] * (len(shape) - 2))) + \
        rng.integers(0, (hi - lo) // 3, shape)
    return np.clip(img, lo, hi - 1).astype(dtype)


def write(path, img, *params):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    ok, buf = cv2.imencode('.png' if str(path).endswith('.png') else '.jpg',
                           img, list(params))
    assert ok
    with open(path, 'wb') as f:
        f.write(buf.tobytes())
    return str(path)


def freiburg_images(root, thermal_bits=16, width=1760, height=40):
    """Two variants per modality at the crop's width: colour JPEGs and a
    16-bit thermal PNG under a .jpg name (values past the clip bounds), or
    an 8-bit thermal JPEG."""
    images = {'rgb': [], 'thermal': [], 'depth': []}
    for v in range(2):
        images['rgb'].append(write(root / f'rgb{v}.jpg', textured(
            (height, width, 3), v), cv2.IMWRITE_JPEG_QUALITY, 90))
        images['depth'].append(write(root / f'depth{v}.jpg', textured(
            (height, width, 3), 10 + v)))
        if thermal_bits == 16:
            png = write(root / f'thermal{v}.png', textured(
                (height, width), 20 + v, 26000, np.uint16, lo=21000))
            os.rename(png, png[:-4] + '.jpg')
            images['thermal'].append(png[:-4] + '.jpg')
        else:
            images['thermal'].append(write(root / f'thermal{v}.jpg',
                                           textured((height, width), 30)))
    return images


@pytest.fixture(scope='module')
def freiburg(tmp_path_factory):
    root = tmp_path_factory.mktemp('freiburg')
    ids = chip_smoke.write_freiburg_tree(
        root / 'tree', freiburg_images(root / 'images'), 4, seed=5,
        clip_s=0.05)
    return root / 'tree', ids


def configs(data_path, **extra):
    over = json.dumps(dict(data_path=str(data_path), image_size=SIZE,
                           **extra))
    return load_config(CONFIG, over), jax_load_config(CONFIG, over)


@pytest.mark.parametrize('normalize', [True, False])
@pytest.mark.parametrize('device_audio_resize', [True, False])
def test_multimodal_items_match_the_jax_dataset(freiburg, normalize,
                                                device_audio_resize):
    tree, ids = freiburg
    tcfg, jcfg = configs(tree, normalize=normalize,
                         device_audio_resize=device_audio_resize)
    got = multimodal.MultimodalDetection(tcfg, 'train')
    want = jax_multimodal.MultimodalDetection(jcfg, 'train')
    # listed newest first, with one id of too short nsecs: sorted, skipped
    assert got.ids == want.ids == ids['train']
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert a['thermal'].shape == (SIZE, SIZE, 1)
        assert a['audio'].shape == ((80 if device_audio_resize else SIZE),
                                    SIZE, 8)
        assert_samples_close(a, b)


def test_multimodal_raw_frames_are_exact(freiburg):
    """The crop, the clip and min-max of the thermal frame, BGR depth and
    the stacked pickles: exact, before any float resize."""
    tree, _ = freiburg
    tcfg, jcfg = configs(tree)
    got = multimodal.MultimodalDetection(tcfg, 'val')
    want = jax_multimodal.MultimodalDetection(jcfg, 'val')
    for frame_id in want.ids:
        a, b = got._load_raw(frame_id), want._load_raw(frame_id)
        for k in ('rgb', 'thermal', 'depth', 'audio'):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a['rgb'].shape == (40, 1520, 3)
        assert 0 <= a['thermal'].min() and a['thermal'].max() == 255


def test_eight_bit_thermal_overflows_on_both_sides(tmp_path):
    tree = tmp_path / 'tree'
    chip_smoke.write_freiburg_tree(
        tree, freiburg_images(tmp_path / 'images', thermal_bits=8), 1,
        seed=1, clip_s=0.02)
    tcfg, jcfg = configs(tree)
    with pytest.raises(OverflowError):
        jax_multimodal.MultimodalDetection(jcfg, 'train')[0]
    with pytest.raises(OverflowError, match='16-bit'):
        multimodal.MultimodalDetection(tcfg, 'train')[0]
    tcfg['use_thermal'] = jcfg['use_thermal'] = 'False'
    assert_samples_close(multimodal.MultimodalDetection(tcfg, 'train')[0],
                         jax_multimodal.MultimodalDetection(jcfg, 'train')[0])


def test_merge_audios_and_yield_batch_match_under_a_seed(freiburg,
                                                         monkeypatch):
    tree, _ = freiburg
    tcfg, jcfg = configs(tree)
    got = multimodal.MultimodalDetection(tcfg, 'train')
    want = jax_multimodal.MultimodalDetection(jcfg, 'train')
    a, b = got.ids[0], got.ids[3]
    mixed = got.merge_audios(a, b)
    ref = want.merge_audios(a, b)
    assert mixed.shape == ref.shape == (SIZE, SIZE, 8)
    assert_close(mixed, ref, rel=MEL_RTOL + REL)
    ours = np.random.default_rng(11)
    monkeypatch.setattr(np.random, 'default_rng',
                        lambda *_: np.random.Generator(np.random.PCG64(11)))
    labels_j, audio_j = want.yield_batch(2, want.ids[:2])
    monkeypatch.undo()
    labels_t, audio_t = got.yield_batch(2, got.ids[:2], ours)
    assert labels_t == labels_j == [None, None]
    assert_close(audio_t, audio_j, rel=MEL_RTOL + REL)
    # without a generator: the dataset's own, seeded from the config
    again = multimodal.MultimodalDetection(tcfg, 'train')
    np.testing.assert_array_equal(got.yield_batch(2, got.ids[:2])[1],
                                  again.yield_batch(2, got.ids[:2])[1])


def _flir_tree(root):
    """FLIR layout: RGB larger than the 8-bit thermal frame it is resized
    to, COCO thermal annotations with a category outside VOC."""
    images, annotations = [], []
    for i, name in enumerate(['FLIR_00002', 'FLIR_00001', 'FLIR_00007']):
        write(root / 'train' / 'RGB' / f'{name}.jpg',
              textured((90, 120, 3), i))
        write(root / 'train' / 'thermal_8_bit' / f'{name}.jpeg',
              textured((48, 64), 10 + i))
        images.append({'id': 100 + i,
                       'file_name': f'thermal_8_bit/{name}.jpeg'})
        annotations += [
            {'image_id': 100 + i, 'category_id': 3,
             'bbox': [4 + i, 5, 20, 10 + i]},
            {'image_id': 100 + i, 'category_id': 1, 'bbox': [1, 2, 3, 4]},
            {'image_id': 100 + i, 'category_id': 99, 'bbox': [1, 2, 3, 4]}]
    with open(root / 'train' / 'thermal_annotations.json', 'w') as f:
        json.dump({'images': images, 'annotations': annotations,
                   'categories': [{'id': 1, 'name': 'person'},
                                  {'id': 3, 'name': 'car'},
                                  {'id': 99, 'name': 'truck'}]}, f)


def test_flir_items_match_the_jax_dataset(tmp_path):
    _flir_tree(tmp_path / 'jax')
    _flir_tree(tmp_path / 'torch')
    tcfg, _ = configs(tmp_path / 'torch', use_labels=True)
    _, jcfg = configs(tmp_path / 'jax', use_labels=True)
    got = flir.FLIRDataset(tcfg, 'train')
    want = jax_flir.FLIRDataset(jcfg, 'train')
    assert got.ids == want.ids == ['FLIR_00001', 'FLIR_00002', 'FLIR_00007']
    with open(tmp_path / 'torch' / 'train' / 'labels.json') as f, \
            open(tmp_path / 'jax' / 'train' / 'labels.json') as g:
        assert json.load(f) == json.load(g)
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert a['thermal'].shape == (SIZE, SIZE, 1)
        assert len(a['label']) == 2
        assert_samples_close(a, b, atol={'rgb': FLIR_RGB_ATOL})
    assert len(got.get_annotations('FLIR_99999')) == 0


def _argoverse_tree(root):
    rng = np.random.default_rng(3)
    for log in ('log_b', 'log_a'):
        for ts in ('315966', '315970'):
            base = root / 'train' / log
            write(base / 'stereo_front_left' /
                  f'stereo_front_left_{ts}.resized.jpg',
                  textured((60, 80, 3), int(ts) % 7))
            depth = rng.uniform(0, 250, (60, 80)).astype('<f4')
            depth[5, 6] = np.inf
            os.makedirs(base / 'stereo_depth', exist_ok=True)
            with open(base / 'stereo_depth' / f'stereo_depth_{ts}.pfm',
                      'wb') as f:
                f.write(b'Pf\n80 60\n-1.0\n' + depth.tobytes())
            os.makedirs(base / 'annotations', exist_ok=True)
            np.savetxt(base / 'annotations' / f'stereo_front_left_{ts}.txt',
                       [[100, 120, 300, 400, 6]] * (1 + int(ts) % 2),
                       delimiter=',')


def test_argoverse_items_match_the_jax_dataset(tmp_path):
    _argoverse_tree(tmp_path)
    tcfg, jcfg = configs(tmp_path, use_labels=True)
    got = argoverse.ArgoverseDataset(tcfg, 'train')
    want = jax_argoverse.ArgoverseDataset(jcfg, 'train')
    assert got.ids == want.ids and len(got) == 4
    for i in range(len(want)):
        assert_samples_close(got[i], want[i])
    depth = jax_argoverse.read_pmf(str(
        tmp_path / 'train/log_a/stereo_depth/stereo_depth_315966.pfm'))
    for log_scale in (False, True):
        np.testing.assert_array_equal(
            argoverse.apply_log_jet_colormap(depth, log_scale),
            jax_argoverse.apply_log_jet_colormap(depth, log_scale))


def _cityscapes_tree(root):
    for city in ('bonn', 'aachen'):
        for k in range(2):
            name = f'{city}_000000_00001{k}'
            write(root / 'leftImg8bit' / 'val' / city /
                  f'{name}_leftImg8bit.png', textured((50, 100, 3), k))
            disparity = textured((50, 100), 5 + k, 60000, np.uint16)
            disparity[:3] = 0
            write(root / 'disparity' / 'val' / city /
                  f'{name}_disparity.png', disparity)
            os.makedirs(root / 'annotations' / 'val' / city, exist_ok=True)
            np.savetxt(root / 'annotations' / 'val' / city /
                       f'{name}_annotations.txt',
                       [[1, 2, 30, 40, 6]] * (k + 1))


def test_cityscapes_items_match_the_jax_dataset(tmp_path):
    """The 16-bit disparity as (d - 1) / 256, clipped at DEPTH_MAX, exact
    without a Resizer. With one, the one-channel depth meets Resizer's
    three-channel pad and both packages raise (reference behaviour, kept);
    without depth the items agree."""
    _cityscapes_tree(tmp_path)
    tcfg, jcfg = configs(tmp_path, val_transformations='Normalizer')
    got = cityscapes.CityScapesDataset(tcfg, 'val')
    want = jax_cityscapes.CityScapesDataset(jcfg, 'val')
    assert got.ids == want.ids and len(got) == 4
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert a['depth'].shape == (50, 100, 1)
        assert a['depth'].max() == cityscapes.DEPTH_MAX
        for k in ('rgb', 'depth', 'label'):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tcfg, jcfg = configs(tmp_path)
    for ds in (cityscapes.CityScapesDataset(tcfg, 'val'),
               jax_cityscapes.CityScapesDataset(jcfg, 'val')):
        with pytest.raises(ValueError, match='could not broadcast'):
            ds[0]
    tcfg, jcfg = configs(tmp_path, use_depth=False)
    got = cityscapes.CityScapesDataset(tcfg, 'val')
    want = jax_cityscapes.CityScapesDataset(jcfg, 'val')
    for i in range(len(want)):
        assert_samples_close(got[i], want[i])


def test_get_dataset_dispatches_every_name(freiburg, tmp_path):
    _flir_tree(tmp_path / 'flir')
    _argoverse_tree(tmp_path / 'argoverse')
    _cityscapes_tree(tmp_path / 'cityscapes')
    trees = {'MultimodalDetection': (freiburg[0], 'train'),
             'FLIRDataset': (tmp_path / 'flir', 'train'),
             'ArgoverseDataset': (tmp_path / 'argoverse', 'train'),
             'CityScapesDataset': (tmp_path / 'cityscapes', 'val')}
    for name, (path, mode) in trees.items():
        tcfg, jcfg = configs(path, dataset=name)
        got = factory.get_dataset(tcfg, mode)
        want = jax_factory.get_dataset(jcfg, mode)
        assert type(got).__name__ == type(want).__name__ == name
        assert type(got).__module__.startswith('mm_distillnet_torch.')
        assert got.ids == want.ids
    tcfg, _ = configs(tmp_path, dataset='Synthetic')
    assert isinstance(factory.get_dataset(tcfg, 'val'), SyntheticMultimodal)
    tcfg['dataset'] = 'CarsAugmented'
    with pytest.raises(ValueError, match='Unsupported dataset'):
        factory.get_dataset(tcfg, 'train')


def _refine_config(cfg_fn, data_path, **extra):
    return cfg_fn(image_size=128, synthetic_size=4, data_path=str(data_path),
                  use_labels='False', nms_candidates=64, max_detections=8,
                  eval_devices=1, valid_labels='car,person,bus',
                  compute_dtype='float32', **extra)


def test_refine_ids_prediction_route_matches_the_reference(
        tmp_path, one_torch_thread):  # noqa: F811
    """refine_ids without labels: the RGB teacher over every frame, the
    CSV cache (id, number of valid predictions, best score), then the
    0.40 cut, in both packages from the same weights."""
    jmod = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
    v = filled_variables(jmod, 4, nhwc_input(0, (1, 128, 128, 3)))
    model = EfficientDet(20, -1, 3)
    sd = state_dict_from_flax(v)
    (tmp_path / 'torch').mkdir()
    (tmp_path / 'jax').mkdir()
    tcfg = _refine_config(default_config, tmp_path / 'torch')
    jcfg = _refine_config(jax_default_config, tmp_path / 'jax')
    got = SyntheticMultimodal(tcfg, 'train')
    want = JaxSynthetic(jcfg, 'train')
    got.refine_ids((model, sd), tcfg, device='cpu')
    want.refine_ids((jmod, v), jcfg)
    name = 'YetAnotherEfficientDet_D2_train_all_predictions.csv'
    with open(tmp_path / 'torch' / name, newline='') as f:
        rows_t = list(csv.reader(f))
    with open(tmp_path / 'jax' / name, newline='') as f:
        rows_j = list(csv.reader(f))
    assert [r[:2] for r in rows_t] == [r[:2] for r in rows_j]
    np.testing.assert_allclose([float(r[2]) for r in rows_t],
                               [float(r[2]) for r in rows_j], atol=1e-4)
    assert got.ids == want.ids


@pytest.mark.parametrize('id_filter', ['None', r'synthetic_drive/00000[13]'])
def test_refine_ids_cuts_the_cached_predictions_at_0_40(tmp_path,
                                                        id_filter):
    """The cache route: a predictions CSV already on disk is read, not
    recomputed; scores above 0.40 stay, then the id filter."""
    ids = [f'synthetic_drive/{i:06d}_{900000000 + i:09d}_v'
           for i in range(6)]
    scores = ['0.39', '0.40', '0.4000001', '0.95', '0.41', '0.0']
    name = 'YetAnotherEfficientDet_D2_train_all_predictions.csv'
    with open(tmp_path / name, 'w') as f:
        f.writelines(f'{i},3,{s}\n' for i, s in zip(ids, scores))
    kept = []
    for cfg_fn, cls in ((default_config, SyntheticMultimodal),
                        (jax_default_config, JaxSynthetic)):
        cfg = _refine_config(cfg_fn, tmp_path, id_filter=id_filter)
        cfg['synthetic_size'] = '6'
        ds = cls(cfg, 'train')
        ds.refine_ids(None, cfg)
        kept.append(ds.ids)
    assert kept[0] == kept[1]
    assert kept[0] == ([ids[2], ids[3], ids[4]] if id_filter == 'None'
                       else [ids[3]])


@pytest.fixture(scope='module')
def freiburg_cli(freiburg, tmp_path_factory):
    """Seeded teacher and student files for the CLIs at test-tiny."""
    root = tmp_path_factory.mktemp('freiburg_cli')
    cwd = os.getcwd()
    os.chdir(root)
    models = root / 'trained_models'
    models.mkdir()
    for seed, (m, ch) in enumerate(CHANNELS.items()):
        jmod = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
        _write_pth(filled_variables(jmod, 70 + seed,
                                    nhwc_input(0, (1, 128, 128, ch))),
                   models / f'yet-another-efficientdet-d2-{m}.pth')
    _write_pth(filled_variables(
        JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32), 80,
        nhwc_input(0, (1, 128, 128, 8))), root / 'student.pth')
    tiny = {k: v for k, v in TINY.items() if k != 'dataset'}
    yield dict(tiny, saved_path=str(models), data_path=str(freiburg[0]),
               student=str(root / 'student.pth'))
    os.chdir(cwd)


class _Stop(Exception):
    """Ends the root train.py once it has built what the test compares."""


def test_train_cli_runs_the_shipped_dataset(freiburg_cli, monkeypatch,
                                            one_torch_thread):  # noqa: F811
    """The shipped config with its own dataset (MultimodalDetection) on a
    Freiburg tree: the port's train CLI trains and scores a student, on
    the same training and validation sets (ids and items) as the root
    train.py builds from the same arguments; both packages' evaluate CLIs
    score the student file on the tree (the JAX one reading it with cv2)
    within PARITY_ATOL."""
    over = dict(freiburg_cli)
    student = over.pop('student')
    assert load_config(CONFIG, json.dumps(over))['dataset'] == \
        'MultimodalDetection'
    monkeypatch.setattr(jax_registry, 'init_variables', _fast_jax_init)
    args = ['--config_file', CONFIG, '--overwrite',
            json.dumps(dict(over, exp_name='train-freiburg', fast_run=True,
                            pretrain_checkpoint=student))]
    sets = {}
    port_train = cli_train.train

    def keep_sets(name, train_fn):
        def wrapper(teachers, student_model, config, train_set, val_set,
                    **kwargs):
            sets[name] = (train_set, val_set)
            if train_fn is None:
                raise _Stop()
            return train_fn(teachers, student_model, config, train_set,
                            val_set, **kwargs)
        return wrapper

    monkeypatch.setattr(cli_train, 'train', keep_sets('port', port_train))
    table = cli_train.main(args + ['--device', 'cpu'])
    monkeypatch.setattr(jax_trainer, 'train', keep_sets('jax', None))
    with pytest.raises(_Stop):
        _import_root('train').main(args)
    for got, want in zip(sets['port'], sets['jax']):
        assert type(got).__name__ == type(want).__name__ == \
            'MultimodalDetection'
        assert got.ids == want.ids and len(got) == 4
        assert_samples_close(got[0], want[0])
    assert os.path.exists('train-freiburg/best.0')
    assert [r['modality'] for r in table] == ['ALL']
    assert all(np.isfinite(table[0][c]) for c in COLUMNS[2:])
    args = ['--config_file', CONFIG, '--checkpoint', student]
    got = cli_evaluate.main(args + ['--device', 'cpu', '--overwrite',
                                    json.dumps(dict(over,
                                                    exp_name='eval-t'))])
    _import_root('evaluate').main(args + ['--overwrite', json.dumps(
        dict(over, exp_name='eval-j'))])
    want = _read_csv('eval-j/results.0.csv')
    resources = _read_csv('eval-t/resources.0.csv')
    assert int(resources[0]['Frames']) == 4
    for col in COLUMNS[2:]:
        g, w = got[0][col], float(want[0][col])
        assert np.isfinite(g)
        assert abs(g - w) <= PARITY_ATOL, (col, g, w)
