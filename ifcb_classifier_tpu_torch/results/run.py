"""Run-results writer — the reference's `save_run_results`
(neuston_callbacks.py:160-272); the port's copy of
ifcb_classifier_tpu/results/run.py.

Fidelity notes:
  * version stamp 'v3' (:167)
  * bin outputs: bin_id + roi_numbers (from target pids), filename templating
    {BIN_ID}/{BIN_YEAR}/{BIN_DATE}/{INPUT_SUBDIRS} with double-sep collapse (:176-184)
  * img outputs: optional per-parent-dir grouping when {INPUT_SUBDIRS} in the
    pattern (:186-202)
  * .mat: output_classes u4+1, scores f4, labels as object array, compressed (:232-250)
  * .h5: metadata attrs, float16 scores AND float16 output_classes (sic, :261),
    uint16 roi_numbers, string dtype inputs (:252-268)
  * reference bug FIXED here (documented, QUIRKS.md): the reference's h5 writer
    reads results['bin_id'] unconditionally and KeyErrors on img-mode runs
    (:264); we check membership like its json/mat writers do.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..data.ifcb import Pid


def save_run_results(input_images, output_scores, class_labels, timestamp,
                     outdir, outfile, model_id=None, input_obj=None):
    """input_obj: a Pid (bin run) or the input src path string (img run)."""
    output_scores = np.asarray(output_scores)
    output_classes = np.argmax(output_scores, axis=1)

    # vs input_images, NOT output_classes (the reference's form was a
    # tautology — argmax of scores always matches the score rows): a
    # packing/bucketing defect upstream must fail here, not silently
    # truncate the img-mode zip or misalign roi_numbers with scores
    if output_scores.shape[0] != len(input_images):
        raise ValueError('score rows ({}) != number of inputs ({})'.format(
            output_scores.shape[0], len(input_images)))
    if output_scores.shape[1] != len(class_labels):
        raise ValueError('score columns ({}) != number of class labels '
                         '({})'.format(output_scores.shape[1],
                                       len(class_labels)))

    results = dict(version='v3', model_id=model_id, timestamp=timestamp,
                   class_labels=list(class_labels), input_images=list(input_images),
                   output_classes=output_classes, output_scores=output_scores)

    outfile = os.path.join(outdir, outfile)
    if isinstance(input_obj, Pid):
        bin_obj = input_obj
        results['bin_id'] = bin_obj.pid
        results['roi_numbers'] = [Pid(img).target for img in input_images]
        fmt = dict(BIN_ID=bin_obj.pid, INPUT_SUBDIRS=bin_obj.namespace,
                   BIN_YEAR=bin_obj.year, BIN_DATE=bin_obj.yearday)
        outfile = outfile.format(**fmt).replace(2 * os.sep, os.sep)
        os.makedirs(os.path.dirname(outfile) or '.', exist_ok=True)
        _save_run_results(outfile, results)
    else:  # image-directory run
        if '{INPUT_SUBDIRS}' in outfile:
            dir_groups = {}
            input_src = input_obj if (input_obj and os.path.isdir(input_obj)) else ''
            for img_path, cls_idx, scores in zip(input_images, output_classes,
                                                 output_scores):
                # PREFIX-anchored strip (QUIRKS.md FIXED row — same rule
                # as bin mode, infer/runner.py): the reference's
                # .replace(src, '') removes EVERY occurrence, so
                # SRC=/data over /data/ifcb/data/D2021/x.png collapsed
                # the namespace and outputs landed in a wrong directory
                rel = (img_path[len(input_src):]
                       if input_src and img_path.startswith(input_src)
                       else img_path)
                parent = os.path.dirname(rel)
                if parent not in dir_groups:
                    dir_groups[parent] = {
                        k: (v if k not in ('input_images', 'output_classes',
                                           'output_scores') else [])
                        for k, v in results.items()}
                dir_groups[parent]['input_images'].append(os.path.basename(img_path))
                dir_groups[parent]['output_classes'].append(cls_idx)
                dir_groups[parent]['output_scores'].append(scores)
            for parent, sub in dir_groups.items():
                sub_outfile = outfile.format(INPUT_SUBDIRS=parent)
                os.makedirs(os.path.dirname(sub_outfile) or '.', exist_ok=True)
                sub['output_classes'] = np.asarray(sub['output_classes'],
                                                   dtype=output_classes.dtype)
                sub['output_scores'] = np.asarray(sub['output_scores'],
                                                  dtype=output_scores.dtype)
                _save_run_results(sub_outfile, sub)
        else:
            os.makedirs(os.path.dirname(outfile) or '.', exist_ok=True)
            _save_run_results(outfile, results)


RUN_OUTFILE_EXTS = ('.json', '.mat', '.h5')


def validate_outfiles(outfiles, src_type='bin'):
    """Fail fast at RUN startup on a bad --outfile pattern — a typo'd
    placeholder or unsupported extension must not surface AFTER hours of
    inference (the front-loading --results and --plot already have;
    render-time discovery loses the whole run's outputs)."""
    for outfile in outfiles or []:
        ext = os.path.splitext(outfile)[-1]
        if ext not in RUN_OUTFILE_EXTS:
            raise ValueError(
                '--outfile {}: unsupported result-file extension {!r}; '
                'choose from {}'.format(outfile, ext or '(none)',
                                        list(RUN_OUTFILE_EXTS)))
        if '{' in outfile or '}' in outfile:
            dummy = (dict(BIN_ID='b', BIN_YEAR=2020, BIN_DATE='d',
                          INPUT_SUBDIRS='') if src_type == 'bin'
                     else dict(INPUT_SUBDIRS=''))
            try:
                outfile.format(**dummy)
            except (KeyError, IndexError, ValueError):
                raise ValueError(
                    '--outfile {}: unknown placeholder; available for '
                    '--type {}: {}'.format(
                        outfile, src_type,
                        sorted('{%s}' % k for k in dummy))) from None


def _save_run_results(outfile, results):
    ext = os.path.splitext(outfile)[-1]
    if ext not in RUN_OUTFILE_EXTS:  # a raise, not an assert: python -O
        # must not turn this into silently writing NOTHING
        raise ValueError(
            'unsupported result-file extension "{}"'.format(ext))
    if outfile.endswith('.json'):
        _save_json(outfile, results)
    if outfile.endswith('.mat'):
        _save_mat(outfile, results)
    if outfile.endswith('.h5'):
        _save_hdf(outfile, results)


def _save_json(outfile, results):
    output = dict(version=results['version'], model_id=results['model_id'],
                  timestamp=results['timestamp'],
                  class_labels=results['class_labels'],
                  output_scores=results['output_scores'].tolist(),
                  output_classes=results['output_classes'].tolist())
    if 'bin_id' in results:
        output['bin_id'] = results['bin_id']
        output['roi_numbers'] = results['roi_numbers']
    else:
        output['input_images'] = results['input_images']
    with open(outfile, 'w') as f:
        json.dump(output, f)


def _save_mat(outfile, results):
    from scipy.io import savemat
    output = dict()
    output['output_classes'] = results['output_classes'].astype('u4') + 1
    output['version'] = results['version']
    output['model_id'] = results['model_id']
    output['timestamp'] = results['timestamp']
    output['output_scores'] = results['output_scores'].astype('f4')
    output['class_labels'] = np.asarray(results['class_labels'], dtype='object')
    if 'bin_id' in results:
        output['bin_id'] = results['bin_id']
        output['roi_numbers'] = results['roi_numbers']
    else:
        output['input_images'] = np.asarray(results['input_images'], dtype='object')
    savemat(outfile, output, do_compression=True)


def _save_hdf(outfile, results):
    import h5py as h5
    with h5.File(outfile, 'w') as f:
        meta = f.create_dataset('metadata', data=h5.Empty('f'))
        meta.attrs['version'] = results['version']
        meta.attrs['model_id'] = results['model_id']
        meta.attrs['timestamp'] = results['timestamp']
        f.create_dataset('output_classes', data=results['output_classes'],
                         compression='gzip', dtype='float16')
        f.create_dataset('output_scores', data=results['output_scores'],
                         compression='gzip', dtype='float16')
        f.create_dataset('class_labels', data=np.bytes_(results['class_labels']),
                         compression='gzip', dtype=h5.string_dtype())
        if 'bin_id' in results:
            meta.attrs['bin_id'] = results['bin_id']
            f.create_dataset('roi_numbers', data=results['roi_numbers'],
                             compression='gzip', dtype='uint16')
        else:
            f.create_dataset('input_images',
                             data=np.bytes_(results['input_images']),
                             compression='gzip', dtype=h5.string_dtype())
