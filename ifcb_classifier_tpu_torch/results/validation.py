"""Validation-results writer — the reference's `SaveValidationResults`
(neuston_callbacks.py:20-156) as a plain function the train loop calls on
best epochs; the port's copy of ifcb_classifier_tpu/results/validation.py.

The statistics are computed in numpy (``prf_scores``, ``confusion_matrix``)
with the semantics of the ``sklearn.metrics`` calls the JAX package makes,
zero-division rule included, because the GPU machine has no sklearn.

Format fidelity notes (all from neuston_callbacks.py):
  * default + optional series selection per `--results FNAME SERIES...` (:51-52,86-105)
  * stats: f1/recall/precision × weighted/macro/perclass, zero_division=0 (:59-64)
  * classes_by_{count,f1,recall,precision} orderings (:66-70)
  * unnormalized confusion matrix over all class idxs (:74)
  * .mat: float64→f4, index arrays +1 for MATLAB 1-indexing, strings as object
    arrays, do_compression=True (:126-139)
  * .h5: scalar stats as metadata attrs, gzip everywhere, int16 ints,
    float16 float arrays, h5 string dtype (:141-156)
  * `{epoch}` filename templating (:108)
  * quirk kept: requesting 'train_counts_perclass' writes val counts under
    the key 'val_counts_perclass' (:98) — documented in QUIRKS.md
"""

from __future__ import annotations

import json
import os

import numpy as np

DEFAULT_SERIES = ('training_image_basenames training_classes image_basenames '
                  'input_classes output_scores confusion_matrix counts_perclass '
                  'f1_perclass f1_weighted f1_macro').split()

STR_SERIES = ['class_labels', 'image_fullpaths', 'image_basenames',
              'training_image_fullpaths', 'training_image_basenames']
IDX_SERIES = (['input_classes', 'output_classes', 'training_classes'] +
              ['classes_by_' + s for s in ('f1', 'recall', 'precision', 'count')])
INT_SERIES = (['input_classes', 'output_classes', 'training_classes'] +
              'counts_perclass val_counts_perclass train_counts_perclass'.split() +
              ['classes_by_' + s for s in ('f1', 'recall', 'precision', 'count')])
ATTR_SERIES = (['model_id', 'timestamp'] +
               'f1_weighted recall_weighted precision_weighted '
               'f1_macro recall_macro precision_macro'.split())


def confusion_matrix(y_true, y_pred, labels):
    """sklearn.metrics.confusion_matrix(y_true, y_pred, labels=labels):
    rows are true classes, columns predicted ones, in ``labels`` order;
    pairs outside ``labels`` are not counted."""
    labels = np.asarray(labels)
    index = {int(v): k for k, v in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(np.asarray(y_true).tolist(), np.asarray(y_pred).tolist()):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm


def prf_scores(y_true, y_pred, labels=None, average=None):
    """(precision, recall, f1) as sklearn's precision_score, recall_score
    and f1_score with zero_division=0 compute them: per class over
    ``labels`` (default: the sorted union of the labels present), or
    averaged — 'macro' unweighted over those labels, 'weighted' by each
    class's support. F1 is 2tp / (2tp + fp + fn), and any 0/0 is 0."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if labels is None:
        labels = np.union1d(y_true, y_pred)
    cm = confusion_matrix(y_true, y_pred, labels)
    tp = np.diag(cm).astype(np.float64)
    pred_sum = cm.sum(axis=0).astype(np.float64)
    true_sum = cm.sum(axis=1).astype(np.float64)

    def divide(num, den):
        return np.where(den == 0, 0.0, num / np.where(den == 0, 1.0, den))

    scores = (divide(tp, pred_sum), divide(tp, true_sum),
              divide(2.0 * tp, true_sum + pred_sum))
    if average is None:
        return scores
    if average == "macro":
        return tuple(float(np.mean(s)) if len(s) else 0.0 for s in scores)
    if average == "weighted":
        total = true_sum.sum()
        return tuple(float(np.sum(s * true_sum) / total) if total else 0.0
                     for s in scores)
    raise ValueError(f"unknown average {average!r}")


def compute_validation_results(series, *, class_labels, input_classes,
                               output_scores, image_fullpaths, model_id,
                               timestamp, counts_perclass, val_counts_perclass,
                               train_counts_perclass, training_image_fullpaths,
                               training_classes):
    """Assemble the results dict for one validation epoch (the callback body,
    neuston_callbacks.py:35-105)."""
    class_idxs = list(range(len(class_labels)))
    output_scores = np.asarray(output_scores)
    input_classes = np.asarray(input_classes)
    output_winscores = np.max(output_scores, axis=1)
    output_classes = np.argmax(output_scores, axis=1)
    image_basenames = [os.path.splitext(os.path.basename(i))[0]
                       for i in image_fullpaths]
    training_image_basenames = [os.path.splitext(os.path.basename(i))[0]
                                for i in training_image_fullpaths]

    assert output_scores.shape[0] == len(input_classes), 'score rows != number of inputs'
    assert output_scores.shape[1] == len(class_labels), 'score columns != number of class labels'

    stats = {}
    for mode in ['weighted', 'macro', None]:
        precision, recall, f1 = prf_scores(input_classes, output_classes,
                                           labels=class_idxs, average=mode)
        for stat, metric in (('f1', f1), ('recall', recall),
                             ('precision', precision)):
            stats['{}_{}'.format(stat, mode if mode else 'perclass')] = metric

    classes_by = {'count': sorted(class_idxs, key=lambda i: counts_perclass[i],
                                  reverse=True)}
    for stat in ['f1', 'recall', 'precision']:
        classes_by[stat] = sorted(class_idxs,
                                  key=lambda i: stats[stat + '_perclass'][i],
                                  reverse=True)

    confusion = confusion_matrix(input_classes, output_classes, class_idxs)

    results = dict(model_id=model_id, timestamp=timestamp,
                   class_labels=list(class_labels),
                   input_classes=input_classes, output_classes=output_classes)
    if 'image_fullpaths' in series:
        results['image_fullpaths'] = list(image_fullpaths)
    if 'image_basenames' in series:
        results['image_basenames'] = image_basenames
    if 'training_image_fullpaths' in series:
        results['training_image_fullpaths'] = list(training_image_fullpaths)
    if 'training_image_basenames' in series:
        results['training_image_basenames'] = training_image_basenames
    if 'training_classes' in series:
        results['training_classes'] = list(training_classes)
    if 'output_winscores' in series:
        results['output_winscores'] = output_winscores
    if 'output_scores' in series:
        results['output_scores'] = output_scores
    if 'confusion_matrix' in series:
        results['confusion_matrix'] = confusion
    if 'counts_perclass' in series:
        results['counts_perclass'] = list(counts_perclass)
    if 'val_counts_perclass' in series:
        results['val_counts_perclass'] = list(val_counts_perclass)
    if 'train_counts_perclass' in series:
        # reference quirk (neuston_callbacks.py:98): writes val counts under
        # the val key when train counts are requested
        results['val_counts_perclass'] = list(val_counts_perclass)
    for stat in stats:
        if stat in series:
            results[stat] = stats[stat]
    for stat in classes_by:
        if 'classes_by_' + stat in series:
            results['classes_by_' + stat] = classes_by[stat]
    return results


VALID_RESULT_EXTS = (".json", ".mat", ".h5")


def validate_result_files(result_files, sample_epoch):
    """Fail-fast validation of `--results FNAME SERIES...` patterns, shared
    by TRAIN and VAL so the rule cannot drift. Catches both failure modes
    BEFORE any compute: a typo'd `{placeholder}` (would crash at the first
    write) and an unsupported extension (worse — `save_validation_results`
    dispatches on extension and silently writes NOTHING).

    sample_epoch is whatever the caller will pass at write time (TRAIN: an
    int; VAL: the string "VAL" — so numeric format specs like
    `{epoch:03d}` are correctly rejected for VAL and accepted for TRAIN).
    """
    for rf in result_files:
        fname = rf[0]
        if not fname.endswith(VALID_RESULT_EXTS):
            raise ValueError(
                "--results {}: unsupported extension (the writer dispatches "
                "on it and would silently write nothing); use one of: {}"
                .format(fname, " ".join(VALID_RESULT_EXTS)))
        if "{" in fname or "}" in fname:  # lone '}' also crashes .format
            try:
                fname.format(epoch=sample_epoch)
            except (KeyError, IndexError, ValueError):
                raise ValueError(
                    "--results {}: unknown FNAME placeholder or a format "
                    "spec incompatible with this command's epoch value "
                    "({!r}); available: {{epoch}}"
                    .format(fname, sample_epoch)) from None


def save_validation_results(outfile: str, results: dict):
    """Dispatch on extension (neuston_callbacks.py:113-116)."""
    if outfile.endswith('.json'):
        _save_json(outfile, dict(results))
    if outfile.endswith('.mat'):
        _save_mat(outfile, dict(results))
    if outfile.endswith('.h5'):
        _save_hdf(outfile, dict(results))


def _save_json(outfile, results):
    for k in results:
        if isinstance(results[k], np.ndarray):
            results[k] = results[k].tolist()
    with open(outfile, 'w') as f:
        json.dump(results, f)


def _save_mat(outfile, results):
    from scipy.io import savemat
    for k in list(results):
        v = results[k]
        if isinstance(v, np.ndarray):
            results[k] = v.astype('f4')
        elif isinstance(v, np.float64):
            results[k] = v.astype('f4')
        elif k in STR_SERIES:
            results[k] = np.asarray(v, dtype='object')
        elif k in IDX_SERIES:
            results[k] = np.asarray(v).astype('u4') + 1  # MATLAB 1-indexing
    savemat(outfile, results, do_compression=True)


def _save_hdf(outfile, results):
    import h5py as h5
    with h5.File(outfile, 'w') as f:
        meta = f.create_dataset('metadata', data=h5.Empty('f'))
        for k, v in results.items():
            if k in ATTR_SERIES:
                meta.attrs[k] = v
            elif k in STR_SERIES:
                f.create_dataset(k, data=np.bytes_(v), compression='gzip',
                                 dtype=h5.string_dtype())
            elif k in INT_SERIES:
                f.create_dataset(k, data=v, compression='gzip', dtype='int16')
            elif isinstance(v, np.ndarray):
                f.create_dataset(k, data=v, compression='gzip', dtype='float16')
            else:
                raise UserWarning('hdf results: unhandled series: {}'.format(k))
