"""Training/validation dataset manifests (host side): the port's copy of
ifcb_classifier_tpu/data/datasets.py, the reference's `NeustonDataset`
(neuston_data.py:21-270).

Folder-per-class scanning, the class-min cutoff and class-max downsample,
class-config CSV remapping (pandas, imported only there), multi-dataset
priority CSVs, and the per-class ratio split with the reference's RNG use
(Python `random`, re-seeded per class inside `split()`), so one seed gives
the JAX package's split. Kept quirk: a class name listed twice maps to its
last index (ROADMAP queue 3). This module makes manifests (image paths and
integer targets); decoding and batching live in data/pipeline.py.
"""

from __future__ import annotations

import os
import random

# torchvision.datasets.folder.IMG_EXTENSIONS (used at neuston_data.py:69,387
# and neuston_net.py:285) — reproduced as a plain constant.
IMG_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.ppm', '.bmp',
                  '.pgm', '.tif', '.tiff', '.webp')


class NeustonDataset:
    """Folder-per-class image manifest with reference-parity semantics.

    Mirrors the reference's neuston_data.py:21-270: the constructor applies the
    class-minimum cutoff (with ignored-class bookkeeping) then the class-maximum
    random downsample, sorts per-class image lists, and flattens to parallel
    (targets, images) tuples ordered by class.
    """

    def __init__(self, src, minimum_images_per_class=1, maximum_images_per_class=None,
                 images_perclass=None):
        self.src = src
        if not images_perclass:
            images_perclass = self.fetch_images_perclass(src)

        # CLASS MINIMUM CUTOFF (neuston_data.py:29-34)
        self.minimum_images_per_class = max(1, minimum_images_per_class)
        ipc_min = {label: images for label, images in images_perclass.items()
                   if len(images) >= self.minimum_images_per_class}
        ignored = sorted(set(images_perclass) - set(ipc_min))
        self.classes_ignored_from_too_few_samples = [
            (c, len(images_perclass[c])) for c in ignored]
        self.classes = sorted(ipc_min.keys())

        # CLASS MAXIMUM LIMITING (neuston_data.py:37-45)
        self.maximum_images_per_class = maximum_images_per_class
        if maximum_images_per_class:
            assert maximum_images_per_class > self.minimum_images_per_class
            ipc_max = {label: sorted(random.sample(images, maximum_images_per_class))
                       if maximum_images_per_class < len(images) else images
                       for label, images in ipc_min.items()}
            ipc_final = ipc_max
            self.classes_limited_from_too_many_samples = [
                c for c in self.classes if len(ipc_max[c]) < len(ipc_min[c])]
        else:
            ipc_final = ipc_min
            self.classes_limited_from_too_many_samples = None

        ipc_final = {label: sorted(images) for label, images in ipc_final.items()}

        # flatten to parallel lists ordered by class (neuston_data.py:51).
        # dict lookup, not list.index: the reference's .index() is an
        # O(N_images x N_classes) string scan (~10^8 comparisons at IFCB
        # scale, paid three times per training start: full set + both
        # split halves); the emitted (targets, images) content — the
        # actual parity surface — is byte-identical
        class_idx = {c: k for k, c in enumerate(self.classes)}
        pairs = [(class_idx[t], i) for t in ipc_final for i in ipc_final[t]]
        if pairs:
            self.targets, self.images = (list(x) for x in zip(*pairs))
        else:
            self.targets, self.images = [], []

    # -- source scanning ----------------------------------------------------

    @classmethod
    def fetch_images_perclass(cls, src, include_exclude_rename=None):
        """Folders in src are the classes (neuston_data.py:54-140).

        src may also be a dataset-configuration CSV whose column headers are
        '[priority:]dataset_path' and whose rows are per-class
        include(1)/exclude(0)/rename directives; datasets merge lowest
        priority-value first, shuffled within a priority level.
        """
        if os.path.isdir(src) and include_exclude_rename is None:
            classes = sorted(d.name for d in os.scandir(src) if d.is_dir())
            images_perclass = {}
            for subdir in classes:
                files = os.listdir(os.path.join(src, subdir))
                files = sorted(f for f in files
                               if os.path.splitext(f)[1] in IMG_EXTENSIONS)
                images_perclass[subdir] = [os.path.join(src, subdir, f) for f in files]
            return images_perclass

        if os.path.isdir(src):  # per-dataset include/exclude/rename
            images_perclass = cls.fetch_images_perclass(src)
            for key, mode in include_exclude_rename:
                if mode == 1 or mode == '1':
                    pass
                elif (mode == 0 or mode == '0') and key in images_perclass:
                    del images_perclass[key]
                else:  # rename/merge
                    if key not in images_perclass:
                        continue
                    new_key = mode
                    if new_key in images_perclass:
                        images_perclass[new_key].extend(images_perclass[key])
                    else:
                        images_perclass[new_key] = images_perclass[key]
                    del images_perclass[key]
            return images_perclass

        # dataset-configuration CSV (neuston_data.py:91-140)
        import pandas as pd
        df = pd.read_csv(src, header=0, index_col=0)
        cols = df.columns.to_list()
        datasets_by_priority = []
        for i in range(len(cols)):
            col = cols[i].split(':', 1)
            if len(col) == 2:
                priority, dataset = int(col[0]), col[1]
            else:
                dataset, priority = col[0], 0
            ier = list(zip(df.index, df[cols[i]].to_list()))
            ipc = cls.fetch_images_perclass(dataset, include_exclude_rename=ier)
            datasets_by_priority.append((priority, dataset, ipc))

        # non-prioritized (0) datasets get lowest priority (max+1)
        priorities = [p for p, _, _ in datasets_by_priority]
        priorities = set(max(priorities) + 1 if p == 0 else p for p in priorities)
        datasets_by_priority = [((max(priorities) if p == 0 else p), d, i)
                                for p, d, i in datasets_by_priority]

        def extend_dol(d1, d2):
            for key in d2:
                if key in d1:
                    d1[key].extend(d2[key])
                else:
                    d1[key] = d2[key]

        images_perclass = {}
        for priority_level in sorted(priorities):
            level_ipc = {}
            for p, _, ipc in datasets_by_priority:
                if p == priority_level:
                    extend_dol(level_ipc, ipc)
            for key in level_ipc:
                random.shuffle(level_ipc[key])
            extend_dol(images_perclass, level_ipc)
        return images_perclass

    # -- views ----------------------------------------------------------------

    @property
    def images_perclass(self):
        ipc = {c: [] for c in self.classes}
        for img, trg in zip(self.images, self.targets):
            ipc[self.classes[trg]].append(img)
        return ipc

    @property
    def count_perclass(self):
        cpc = [0 for _ in self.classes]
        for class_idx in self.targets:
            cpc[class_idx] += 1
        return cpc

    # -- split ----------------------------------------------------------------

    def split(self, ratio1, ratio2, seed=None):
        """Per-class random split (neuston_data.py:157-184).

        Parity notes (load-bearing, see SURVEY.md §7 quirks): `random.seed(seed)`
        is re-applied *inside* the per-class loop; d1 size rounds half-up; if a
        class would send zero images to d2 while class-min > 1, one image is
        moved; d2 is the sorted set-difference.
        """
        assert ratio1 + ratio2 == 100, \
            '--split percentages {}:{} add up to {}, not 100'.format(
                ratio1, ratio2, ratio1 + ratio2)
        d1_perclass, d2_perclass = {}, {}
        for class_label, images in self.images_perclass.items():
            d1_len = int(ratio1 * len(images) / 100 + 0.5)
            if d1_len == len(images) and self.minimum_images_per_class > 1:
                d1_len -= 1
            if seed:
                random.seed(seed)
            d1_images = random.sample(images, d1_len)
            d2_images = sorted(set(images) - set(d1_images))
            assert len(d1_images) + len(d2_images) == len(images)
            d1_perclass[class_label] = d1_images
            d2_perclass[class_label] = d2_images

        dataset1 = NeustonDataset(src=self.src, images_perclass=d1_perclass)
        dataset2 = NeustonDataset(src=self.src, images_perclass=d2_perclass)
        # KEPT quirk (QUIRKS.md): with --class-min 1 a tiny class can round
        # its ENTIRE membership into d1 (the one-image-to-val guarantee
        # above only fires when class-min > 1, neuston_data.py:164-166) and
        # the reference crashes on its classes-agree assert. Same crash
        # here — split membership parity pins the rounding — but the
        # message names the actual cause and the fix.
        assert dataset1.classes == dataset2.classes, \
            'split halves disagree on classes: only-in-d1={}, only-in-d2={}' \
            ' — a class too small for --split {}:{} sent every image to one' \
            ' half (raise --class-min above 1, or drop the class)'.format(
                set(dataset1.classes) - set(dataset2.classes),
                set(dataset2.classes) - set(dataset1.classes),
                ratio1, ratio2)
        assert len(dataset1) + len(dataset2) == len(self)
        return dataset1, dataset2

    # -- class-config CSV -------------------------------------------------------

    @classmethod
    def from_csv(cls, src, csv_file, column_to_run,
                 minimum_images_per_class=1, maximum_images_per_class=None):
        """Class-config CSV: 0=drop, 1=keep, other=rename/merge
        (neuston_data.py:186-255), with the same reporting prints."""
        import pandas as pd
        df = pd.read_csv(csv_file, header=0)
        base_list = df.iloc[:, 0].tolist()
        mod_list = df[column_to_run].tolist()

        default_ipc = cls.fetch_images_perclass(src)
        missing_classes_src = [c for c in default_ipc if c not in base_list]

        new_ipc = {}
        missing_classes_csv, skipped_classes = [], []
        grouped_classes = {}
        for base, mod in zip(base_list, mod_list):
            if base not in default_ipc:
                missing_classes_csv.append(base)
                continue
            if str(mod) == '0':
                skipped_classes.append(base)
                continue
            elif str(mod) == '1':
                class_label = base
            else:
                class_label = mod
                grouped_classes.setdefault(mod, []).append(base)
            if class_label not in new_ipc:
                new_ipc[class_label] = list(default_ipc[base])
            else:
                new_ipc[class_label].extend(default_ipc[base])

        if missing_classes_src:
            msg = '\n{} of {} class dirs under {} have no row in {}'.format(
                len(missing_classes_src), len(default_ipc), src,
                os.path.basename(csv_file))
            print('\n    '.join([msg] + missing_classes_src))
        if missing_classes_csv:
            msg = '\n{} of {} rows in {} match no class dir under {}'.format(
                len(missing_classes_csv), len(base_list),
                os.path.basename(csv_file), src)
            print('\n    '.join([msg] + missing_classes_csv))
        if grouped_classes:
            print('\n{} merged classes built from the groupings in {}'.format(
                len(grouped_classes), os.path.basename(csv_file)))
            for mod, bases in grouped_classes.items():
                print('  {}'.format(mod))
                print('\n'.join('     <-- {}'.format(c) for c in bases))
        if skipped_classes:
            msg = '\n{} classes dropped by {}'.format(
                len(skipped_classes), os.path.basename(csv_file))
            print('\n    '.join([msg] + skipped_classes))

        if not new_ipc:
            # FIXED quirk (QUIRKS.md): the reference would pass {} into the
            # constructor, whose `if not images_perclass` treats it as "no
            # config given" and silently RESCANS src — training on every
            # class with the config ignored. A config that drops/mismatches
            # everything is an input error; fail loudly instead.
            raise ValueError(
                "--class-config {} column {!r} leaves no classes: every row "
                "is dropped (0) or matches no class dir under {}".format(
                    os.path.basename(csv_file), column_to_run, src))

        return cls(src=src, images_perclass=new_ipc,
                   minimum_images_per_class=minimum_images_per_class,
                   maximum_images_per_class=maximum_images_per_class)

    def __len__(self):
        return len(self.images)


def scan_dataset(args):
    """NeustonDataset from an argparse namespace — the ONE mapping from the
    (SRC, --class-config, --class-min/--class-max) flag surface to a scanned
    dataset, shared by TRAIN (here), VAL (train/evaluate.py), and
    CALC_IMG_NORM (util_cli.py). They used to carry three verbatim copies;
    a --class-config semantics change applied to one would silently make
    VAL evaluate a different class mapping than TRAIN trained on."""
    if not getattr(args, "class_config", None):
        return NeustonDataset(src=args.SRC,
                              minimum_images_per_class=args.class_min,
                              maximum_images_per_class=args.class_max)
    return NeustonDataset.from_csv(
        src=args.SRC, csv_file=args.class_config[0],
        column_to_run=args.class_config[1],
        minimum_images_per_class=args.class_min,
        maximum_images_per_class=args.class_max)


def get_trainval_datasets(args):
    """Dataset construction + split + reporting (neuston_data.py:292-329).

    Returns (training_dataset, validation_dataset) manifests; transforms are a
    device-side concern here (ops/preprocess.py), so unlike the reference no
    transform objects are attached.
    """
    print('Scanning dataset...')
    nd = scan_dataset(args)
    ratio1, ratio2 = map(int, args.split.split(':'))
    dataset_tup = nd.split(ratio1, ratio2, seed=args.seed)
    if not getattr(args, 'swap', False):
        training_dataset, validation_dataset = dataset_tup
    else:
        validation_dataset, training_dataset = dataset_tup

    ci_nd = nd.classes_ignored_from_too_few_samples
    ci_train = training_dataset.classes_ignored_from_too_few_samples
    ci_eval = validation_dataset.classes_ignored_from_too_few_samples
    assert ci_eval == ci_train
    if ci_nd:
        msg = '\n{} of {} classes fall below --class-minimum {} before the split'.format(
            len(ci_nd), len(nd.classes) + len(ci_nd), args.class_min)
        print('\n    '.join([msg] + ['({:2}) {}'.format(l, c) for c, l in ci_nd]))
    if ci_eval:
        msg = '\n{} of {} classes fall below --class-minimum {} after the split'.format(
            len(ci_eval), len(validation_dataset.classes) + len(ci_eval), args.class_min)
        print('\n    '.join([msg] + ['({:2}) {}'.format(l, c) for c, l in ci_eval]))

    return training_dataset, validation_dataset


def parse_imgnorm(img_norm_arg):
    """1-or-3 comma-separated floats broadcast to 3 channels
    (neuston_data.py:331-339)."""
    mean = [float(m) for m in img_norm_arg[0].split(',')]
    if len(mean) == 1:
        mean = 3 * mean
    std = [float(s) for s in img_norm_arg[1].split(',')]
    if len(std) == 1:
        std = 3 * std
    if not len(mean) == len(std) == 3:
        raise ValueError('--img-norm invalid: {}'.format(img_norm_arg))
    return mean, std


def list_image_paths(src, filter_mode=None, filter_keywords=()):
    """Image paths under ``src`` (the JAX package's data/datasets.py:356,
    the reference's neuston_net.py:282-301): a recursive directory walk
    (sorted), a .txt list, or one image; then the IN/OUT keyword filter.
    Serves ``RUN --calib DIR`` on an image folder (export._load_calib_batch)
    now, and image-directory RUN with P6."""
    img_paths = []
    if os.path.isdir(src):
        for pardir, _, imgs in os.walk(src):
            img_paths.extend(os.path.join(pardir, img) for img in imgs
                             if img.endswith(IMG_EXTENSIONS))
        img_paths.sort()
    elif os.path.isfile(src) and src.endswith('.txt'):
        with open(src) as f:
            img_paths = [line.strip() for line in f.read().splitlines()]
            img_paths = [img for img in img_paths
                         if img.endswith(IMG_EXTENSIONS)]
    elif src.endswith(IMG_EXTENSIONS):
        img_paths.append(src)

    if filter_mode == 'IN':
        img_paths = [img for img in img_paths
                     if any(k in img for k in filter_keywords)]
    elif filter_mode == 'OUT':
        img_paths = [img for img in img_paths
                     if not any(k in img for k in filter_keywords)]
    return img_paths
