"""The port's config, dataset and loader modules against the reference's:
they are numpy and configparser only, so the results are equal."""
import numpy as np
import pytest
import torch

from mm_distillnet_tpu import config as jax_config
from mm_distillnet_tpu.data import base as jax_base
from mm_distillnet_tpu.data.loader import DataLoader as JaxLoader
from mm_distillnet_tpu.data.loader import collate as jax_collate
from mm_distillnet_tpu.data.synthetic import \
    SyntheticMultimodal as JaxSynthetic
from mm_distillnet_tpu.train.trainer import \
    distill_config_from as jax_distill_config_from
from mm_distillnet_torch import config as tconfig
from mm_distillnet_torch.data import base
from mm_distillnet_torch.data.loader import DataLoader, collate
from mm_distillnet_torch.data.synthetic import SyntheticMultimodal
from mm_distillnet_torch.distill.train_step import DistillConfig
from mm_distillnet_torch.train.trainer import distill_config_from


def test_defaults_equal_reference():
    assert tconfig.DEFAULTS == jax_config.DEFAULTS
    assert dict(tconfig.default_config(image_size=128)) == \
        dict(jax_config.default_config(image_size=128))


def test_load_config_with_overwrite(tmp_path):
    path = tmp_path / 'run.cfg'
    path.write_text('[DEFAULT]\nimage_size = 256\nuse_depth = False\n'
                    'lr = 1e-4\n')
    args = (str(path), '{"image_size": 128, "exp_name": "x"}',
            {'batch_size': 4})
    got = tconfig.load_config(*args)
    assert dict(got) == dict(jax_config.load_config(*args))
    assert got.getint('image_size') == 128 and got.getint('batch_size') == 4
    assert got.getboolean('use_depth') is False
    assert got.getfloat('lr') == 1e-4
    with pytest.raises(FileNotFoundError):
        tconfig.load_config(str(tmp_path / 'missing.cfg'))


def test_student_input_key_and_transfer_dtype():
    for kw in ({}, {'student_modality': 'thermal'},
               {'student_modality': 'thermal', 'student_input': 'rgb'}):
        assert tconfig.student_input_key(tconfig.default_config(**kw)) == \
            jax_config.student_input_key(jax_config.default_config(**kw))
    dt = tconfig.transfer_dtype_from
    assert dt(tconfig.default_config()) is torch.bfloat16
    assert dt(tconfig.default_config(compute_dtype='float32')) is None
    assert dt(tconfig.default_config(transfer_dtype='float32')) is None
    assert dt(tconfig.config_from_dict(
        {'compute_dtype': 'float32', 'transfer_dtype': 'bfloat16'})) \
        is torch.bfloat16
    # the reference casts on the same settings
    assert jax_config.transfer_dtype_from(
        jax_config.default_config(compute_dtype='float32')) is None
    assert jax_config.transfer_dtype_from(jax_config.default_config()) \
        is not None


@pytest.mark.parametrize('overrides', [
    {}, {'w_kd': 0.01, 'max_gt': 16, 'nms_candidates': 64,
         'max_det_per_teacher': 8, 'use_labels': True, 'div_loss': 'DistillKL',
         'student_input': 'rgb', 'conf_threshold': 0.25}],
    ids=['defaults', 'overrides'])
def test_distill_config_equals_reference(overrides):
    got = distill_config_from(tconfig.default_config(**overrides), 128)
    want = jax_distill_config_from(jax_config.default_config(**overrides),
                                   128)
    assert isinstance(got, DistillConfig)
    assert got._asdict().keys() == want._asdict().keys()
    assert got == want and got.pl._asdict() == want.pl._asdict()


def test_class_tables_equal_reference():
    cfg = tconfig.default_config(valid_labels='car,person')
    got = base.build_valid_classes_dict(base.VOC_CLASSES, cfg)
    assert got == jax_base.build_valid_classes_dict(jax_base.VOC_CLASSES, cfg)
    np.testing.assert_array_equal(base.prediction_to_label_lut(got, 20),
                                  jax_base.prediction_to_label_lut(got, 20))
    assert base.valid_prediction_ids(got) == [6, 14]
    labels = np.asarray([[0, 0, 5, 5, 6], [1, 1, 4, 4, 3]], np.float32)
    np.testing.assert_array_equal(base.filter_labels(labels, got),
                                  jax_base.filter_labels(labels, got))


@pytest.mark.parametrize('compact', [True, False],
                         ids=['compact_audio', 'full_audio'])
def test_synthetic_frames_equal_reference(compact):
    kw = dict(image_size=64, synthetic_size=3, device_audio_resize=compact)
    got = SyntheticMultimodal(tconfig.default_config(**kw), 'test')
    want = JaxSynthetic(jax_config.default_config(**kw), 'test')
    assert len(got) == len(want) == 3 and got.ids == want.ids
    for i in range(3):
        a, b = got[i], want[i]
        assert a.keys() == b.keys() and a['id'] == b['id']
        assert a['audio'].shape == ((80 if compact else 64), 64, 8)
        for key in ('rgb', 'thermal', 'depth', 'audio', 'label'):
            np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(got.get_annotations(got.ids[1]),
                                  want.get_annotations(want.ids[1]))
    with pytest.raises(ValueError):   # cached frames are frozen
        got[0]['rgb'][0, 0, 0] = 1.0


def test_loader_batches_equal_reference():
    kw = dict(image_size=64, synthetic_size=5)
    tset = SyntheticMultimodal(tconfig.default_config(**kw), 'val')
    jset = JaxSynthetic(jax_config.default_config(**kw), 'val')
    one = collate([tset[0], tset[1]], max_gt=4)
    ref = jax_collate([jset[0], jset[1]], max_gt=4)
    assert one['label'].shape == (2, 4, 5) and one['id'] == ref['id']
    for key in ('rgb', 'thermal', 'depth', 'audio', 'label'):
        np.testing.assert_array_equal(one[key], ref[key])
    for loader_kw in (dict(shuffle=False, drop_last=False),
                      dict(shuffle=True, drop_last=True, seed=3),
                      dict(process_index=1, process_count=2,
                           drop_last=False)):
        got = DataLoader(tset, 2, num_workers=2, **loader_kw)
        want = JaxLoader(jset, 2, num_workers=2, **loader_kw)
        assert len(got) == len(want)
        got.set_epoch(1)
        want.set_epoch(1)
        batches = list(zip(got, want))
        assert len(batches) == len(want)
        for a, b in batches:
            assert a['id'] == b['id']
            np.testing.assert_array_equal(a['audio'], b['audio'])
            np.testing.assert_array_equal(a['label'], b['label'])


def test_refine_ids_with_labels():
    """The annotation route of refine_ids: frames with more than one valid
    label stay, as in the reference."""
    kw = dict(image_size=64, synthetic_size=24)
    tset = SyntheticMultimodal(tconfig.default_config(**kw), 'train')
    jset = JaxSynthetic(jax_config.default_config(**kw), 'train')
    tset.use_labels = jset.use_labels = True
    tset.refine_ids(None, tset.config)
    jset.refine_ids(None, jset.config)
    assert tset.ids == jset.ids and 0 < len(tset) < 24
