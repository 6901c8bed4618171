"""Dataset for one-shot detection (host side).

Counterpart of `DatasetOneShotDetection` in `os2d_tpu/data/dataset.py`
(the reference's os2d/data/dataset.py:558-734): scene images and GT class
images from a CSV-schema dataframe (relative box coordinates scaled at load),
the aspect-preserving resize to the dataset's image_size, optional in-RAM
caching, buckets of equal image size, and the per-image annotations; and
the builders by dataset name (`build_dataset_by_name`: GroZi-3.2k, the
retail sets dairy and paste, INSTRE, ImageNet-RepMet), which read the
datasets' files in their published layouts under a data path
(os2d_tpu/data/dataset.py:38-376). INSTRE and the RepMet episodes are
converted to the CSV schema on first use, next to their sources.
"""

from __future__ import annotations

import copy
import glob
import logging
import os
import pickle
import xml.etree.ElementTree as ElementTree
from collections import OrderedDict

import numpy as np
import pandas as pd
from PIL import Image

from ..structures.feature_map import FeatureMapSize, exact_resize_area
from ..structures.host_boxes import HostBoxes

REQUIRED_COLUMNS = {
    "imageid", "imagefilename", "classid", "classfilename",
    "gtbboxid", "difficult", "lx", "ty", "rx", "by",
}


def read_image(path):
    with open(path, "rb") as f:
        img = Image.open(f)
        if img.mode != "RGB":
            img = img.convert("RGB")
        img.load()
    return img


def read_annotation_file(path):
    df = pd.read_csv(path)
    if "imagefilename" not in df.columns:
        df["imagefilename"] = [f"{row}.jpg" for row in df["imageid"]]
    if "classfilename" not in df.columns:
        df["classfilename"] = [f"{row}.jpg" for row in df["classid"]]
    assert REQUIRED_COLUMNS.issubset(df.columns), (
        f"Missing columns in gtboxframe: {REQUIRED_COLUMNS - set(df.columns)}"
    )
    return df


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def build_grozi_dataset(data_path, name, eval_scale, cache_images=False,
                        no_image_reading=False, logger_prefix="OS2D"):
    """GroZi-3.2k subsets: train / val-old-cl / val-new-cl / val-all /
    train-mini (2 images — the de-facto smoke set)."""
    image_size = 3264
    classdatafile = os.path.join(data_path, "grozi", "classes", "grozi.csv")
    gt_path = os.path.join(data_path, "grozi", "classes", "images")
    image_path = os.path.join(data_path, "grozi", "src", str(image_size))
    df = read_annotation_file(classdatafile)

    subset = name.lower()[len("grozi-"):]
    assert subset in ["train", "val-old-cl", "val-new-cl", "val-all", "train-mini"], name

    def unique_images(frame):
        u = frame[["imageid", "imagefilename"]].drop_duplicates()
        return list(u["imageid"]), list(u["imagefilename"])

    if subset in ("train", "train-mini"):
        df = df[df["split"] == "train"]
        image_ids, image_file_names = unique_images(df)
        if subset == "train-mini":
            image_ids = image_ids[:2]
            image_file_names = image_file_names[:2]
            df = df[df["imageid"].isin(image_ids)]
    else:
        df = df[df["split"].isin(["val-old-cl", "val-new-cl"])]
        image_ids, image_file_names = unique_images(df)
        if subset != "val-all":
            df = df[df["split"] == subset]

    return DatasetOneShotDetection(
        df, gt_path, image_path, name, image_size, eval_scale,
        image_ids=image_ids, image_file_names=image_file_names,
        cache_images=cache_images, no_image_reading=no_image_reading,
        logger_prefix=logger_prefix,
    )


def build_eval_dataset(data_path, name, eval_scale, cache_images=False,
                       no_image_reading=False, logger_prefix="OS2D"):
    """Retail test sets: dairy (image_size 3000), paste-v / paste-f (1280;
    -f clears difficult flags)."""
    if name.lower() == "dairy":
        image_size = 3000
        classdatafile = os.path.join(data_path, "dairy", "classes", "dairy.csv")
        gt_path = os.path.join(data_path, "dairy", "classes", "images")
        image_path = os.path.join(data_path, "dairy", "src", "original")
        df = read_annotation_file(classdatafile)
    elif name.lower() in ("paste-v", "paste-f"):
        image_size = 1280
        classdatafile = os.path.join(data_path, "paste", "classes", "paste.csv")
        df = read_annotation_file(classdatafile)
        if name.lower() == "paste-f":
            df["difficult"] = 0
        gt_path = os.path.join(data_path, "paste", "classes", "images")
        image_path = os.path.join(data_path, "paste", "src", "original")
    else:
        raise RuntimeError(f"Unknown dataset {name}")
    return DatasetOneShotDetection(
        df, gt_path, image_path, name, image_size, eval_scale,
        cache_images=cache_images, no_image_reading=no_image_reading,
        logger_prefix=logger_prefix,
    )


def build_instre_dataset(data_path, name, eval_scale, cache_images=False,
                         no_image_reading=False, logger_prefix="OS2D"):
    """INSTRE S1/S2: converts gnd_instre.mat + per-image xywh .txt boxes into
    the CSV schema on first call (os2d/data/dataset.py:126-286), then class-wise
    75/5/20 train/val/test splits."""
    logger = logging.getLogger(f"{logger_prefix}.dataset")
    image_size = 1000
    dataset_path = os.path.join(data_path, "instre")
    image_path = dataset_path
    gt_path = os.path.join(dataset_path, "classes")
    gt_image_path = os.path.join(gt_path, "images")
    classdatafile = os.path.join(gt_path, "instre.csv")

    if not os.path.isfile(classdatafile):
        import scipy.io as sio

        os.makedirs(gt_image_path, exist_ok=True)
        logger.info(f"Creating {classdatafile} from INSTRE source data")
        ann = sio.loadmat(os.path.join(dataset_path, "gnd_instre.mat"))
        qimlist = ann["qimlist"].flatten()
        imlist = ann["imlist"].flatten()
        gnd = ann["gnd"].flatten()
        rows = []
        for i_class in range(len(qimlist)):
            query_rel = str(qimlist[i_class][0])
            if query_rel.split("/")[0].lower() == "instre-m":
                continue  # INSTRE-M queries contain two objects
            query_bbox = gnd[i_class][1].flatten()
            positives = gnd[i_class][0].flatten() - 1  # MATLAB indexing
            classfilename = f"{i_class:05d}_{'_'.join(query_rel.split('/'))}"
            out_file = os.path.join(gt_image_path, classfilename)
            if not os.path.isfile(out_file):
                read_image(os.path.join(dataset_path, query_rel)).crop(
                    query_bbox
                ).save(out_file)

            def get_boxes(image_filename):
                txt = os.path.join(
                    image_path, image_filename.split(".")[0] + ".txt"
                )
                with open(txt) as fo:
                    boxes = [
                        [int(s) for s in line.split(" ")] for line in fo if line.strip()
                    ]
                img = read_image(os.path.join(image_path, image_filename))
                sz = FeatureMapSize.from_image(img)

                def rel_xywh(b):
                    lx = float(b[0]) / sz.w
                    ty = float(b[1]) / sz.h
                    return lx, ty, lx + float(b[2]) / sz.w, ty + float(b[3]) / sz.h

                qs = query_rel.split("/")
                ims = image_filename.split("/")
                if qs[0].lower() == "instre-s1" and ims[0].lower() == "instre-m":
                    i_box = 0 if qs[1][2] == "a" else 1
                    return [rel_xywh(boxes[i_box])]
                return [rel_xywh(b) for b in boxes]

            for image_id in positives:
                image_file_name = str(imlist[image_id][0])
                for box in get_boxes(image_file_name):
                    rows.append(
                        OrderedDict(
                            gtbboxid=len(rows), classid=i_class,
                            classfilename=classfilename, imageid=int(image_id),
                            imagefilename=image_file_name, difficult=0,
                            lx=box[0], ty=box[1], rx=box[2], by=box[3],
                        )
                    )
        pd.DataFrame(rows).to_csv(classdatafile)

    df = read_annotation_file(classdatafile)
    subset = name.lower()[len("instre-"):]
    assert subset in ["all", "s1-train", "s1-val", "s1-test",
                      "s2-train", "s2-val", "s2-test"], name
    if subset != "all":
        tag = "INSTRE-S1" if subset.startswith("s1") else "INSTRE-S2"
        df = df[df.classfilename.str.contains(tag)]
        classes = df.classfilename.drop_duplicates()
        if subset.endswith("train"):
            classes = classes[: len(classes) * 75 // 100]
        elif subset.endswith("test"):
            classes = classes[len(classes) * 8 // 10:]
        else:
            classes = classes[len(classes) * 75 // 100: len(classes) * 8 // 10]
        df = df[df.classfilename.isin(classes)]

    return DatasetOneShotDetection(
        df, gt_image_path, image_path, name, image_size, eval_scale,
        cache_images=cache_images, no_image_reading=no_image_reading,
        logger_prefix=logger_prefix,
    )


def build_repmet_dataset(data_path, name, eval_scale=None, cache_images=False,
                         no_image_reading=False, logger_prefix="OS2D"):
    """ImageNet-LOC episodes from RepMet pickles + ImageNet train/val with
    RepMet test classes excluded (os2d/data/dataset.py:289-544)."""
    logger = logging.getLogger(f"{logger_prefix}.dataset")
    subset = name.lower()[len("imagenet-repmet-"):]
    if subset.startswith("test-episode"):
        df, gt_path, image_path, image_size = _build_imagenet_test_episode(
            subset, data_path, logger
        )
    else:
        df, gt_path, image_path, image_size = _build_imagenet_trainval(
            subset, data_path, logger
        )
    return DatasetOneShotDetection(
        df, gt_path, image_path, name, image_size, eval_scale,
        cache_images=cache_images, no_image_reading=no_image_reading,
        logger_prefix=logger_prefix,
    )


def _build_imagenet_test_episode(subset_name, data_path, logger):
    episode_id = int(subset_name.split("-")[-1])
    epi_data_name = "epi_inloc_in_domain_1_5_10_500"
    image_size = 1000
    dataset_path = os.path.join(data_path, "ImageNet-RepMet")
    with open(os.path.join(dataset_path, "RepMet_CVPR2019_data", "data",
                           "Imagenet_LOC", "voc_inloc_roidb.pkl"), "rb") as fid:
        roidb = pickle.load(fid, encoding="latin1")
    with open(os.path.join(dataset_path, "RepMet_CVPR2019_data", "data",
                           "Imagenet_LOC", "episodes", f"{epi_data_name}.pkl"),
              "rb") as fid:
        episode_data = pickle.load(fid, encoding="latin1")
    episode = episode_data[episode_id]
    dataset_image_path = os.path.join(dataset_path, "ILSVRC")
    swap_src = "/dccstor/leonidka1/data/imagenet/ILSVRC/"

    gt_path = os.path.join(dataset_path, epi_data_name, f"classes_episode_{episode_id}")
    gt_image_path = os.path.join(gt_path, "images")
    os.makedirs(gt_image_path, exist_ok=True)
    classdatafile = os.path.join(
        gt_path, f"classes_{epi_data_name}_episode_{episode_id}.csv"
    )
    if not os.path.isfile(classdatafile):
        rows = []
        gt_filename_by_id = {}
        for train_boxes_data in episode["train_boxes"]:
            class_id = train_boxes_data[0]
            query_rel = train_boxes_data[2].replace(swap_src, "")
            query_bbox = train_boxes_data[3].flatten()
            classfilename = f"{class_id:05d}_{'_'.join(query_rel.split('/'))}"
            if class_id not in gt_filename_by_id:
                read_image(os.path.join(dataset_image_path, query_rel)).crop(
                    query_bbox
                ).save(os.path.join(gt_image_path, classfilename))
                gt_filename_by_id[class_id] = classfilename

        def find_in_roidb(fname):
            for i, im_data in enumerate(roidb["roidb"]):
                if im_data["image"] == fname:
                    return i
            return None

        for image_file_name in episode["query_images"]:
            image_id = find_in_roidb(image_file_name)
            im_data = roidb["roidb"][image_id]
            rel_name = image_file_name.replace(swap_src, "")
            w, h = int(im_data["width"]), int(im_data["height"])
            for box, class_id in zip(im_data["boxes"], im_data["gt_classes"]):
                if class_id in gt_filename_by_id:
                    rows.append(
                        OrderedDict(
                            imageid=int(image_id), imagefilename=rel_name,
                            classid=int(class_id),
                            classfilename=gt_filename_by_id[class_id],
                            gtbboxid=len(rows), difficult=0,
                            lx=float(box[0]) / w, ty=float(box[1]) / h,
                            rx=float(box[2]) / w, by=float(box[3]) / h,
                        )
                    )
        pd.DataFrame(rows).to_csv(classdatafile)
    return pd.read_csv(classdatafile), gt_image_path, dataset_image_path, image_size


def _build_imagenet_trainval(subset_name, data_path, logger):
    image_size = 1000
    dataset_path = os.path.join(data_path, "ImageNet-RepMet", "ILSVRC")
    with open(os.path.join(data_path, "ImageNet-RepMet",
                           "repmet_test_classes.txt")) as fid:
        classes_to_exclude = {line.strip(): 1 for line in fid if line.strip()}
    annotation_path = os.path.join(dataset_path, "Annotations", "CLS-LOC")
    image_path = os.path.join(dataset_path, "Data", "CLS-LOC")

    if subset_name.startswith("train"):
        annotations = glob.glob(os.path.join(annotation_path, "train", "*", "*.xml"))
    else:
        annotations = glob.glob(os.path.join(annotation_path, "val", "*.xml"))
    annotations = sorted(annotations)

    rows = []
    for image_id, xml_file in enumerate(annotations):
        root = ElementTree.parse(xml_file).getroot()
        filename = root.find("filename").text
        size = root.find("size")
        w = int(size.find("width").text)
        h = int(size.find("height").text)
        if subset_name == "train":
            class_dir = filename.split("_")[0]
            if class_dir in classes_to_exclude:
                continue
            image_file_name = os.path.join("train", class_dir, filename + ".JPEG")
        else:
            image_file_name = os.path.join("val", filename + ".JPEG")
        for obj in root.iter("object"):
            class_id = obj.find("name").text
            if class_id in classes_to_exclude:
                continue
            difficult = int(obj.find("difficult").text)
            box = obj.find("bndbox")
            rows.append(
                OrderedDict(
                    imageid=image_id, imagefilename=image_file_name,
                    classid=int(class_id[1:]), classfilename=None,
                    gtbboxid=len(rows), difficult=difficult,
                    lx=int(box.find("xmin").text) / w,
                    ty=int(box.find("ymin").text) / h,
                    rx=int(box.find("xmax").text) / w,
                    by=int(box.find("ymax").text) / h,
                )
            )
    if subset_name.startswith("val-"):
        new_size = int(subset_name.split("-")[-1])
        rows = rows[:: len(rows) // new_size][:new_size]
    return pd.DataFrame(rows), None, image_path, image_size


def build_dataset_by_name(data_path, name, eval_scale, cache_images=False,
                          no_image_reading=False, logger_prefix="OS2D"):
    lname = name.lower()
    if lname.startswith("grozi"):
        builder = build_grozi_dataset
    elif lname.startswith("instre"):
        builder = build_instre_dataset
    elif lname.startswith("imagenet-repmet"):
        builder = build_repmet_dataset
    else:
        builder = build_eval_dataset
    return builder(data_path, name, eval_scale, cache_images=cache_images,
                   no_image_reading=no_image_reading, logger_prefix=logger_prefix)


class DatasetOneShotDetection:
    """Images + GT class images + box annotations from a CSV dataframe
    (os2d/data/dataset.py:558-734). With no_image_reading neither the class
    images nor the scene images are opened (a dataset built only for its
    annotations, as the train builder makes when not training)."""

    def __init__(self, gtboxframe, gt_path, image_path, name, image_size,
                 eval_scale, cache_images=False, image_ids=None,
                 image_file_names=None, logger_prefix="OS2D", no_image_reading=False):
        self.logger = logging.getLogger(f"{logger_prefix}.dataset")
        self.name = name
        self.image_size = image_size
        self.eval_scale = eval_scale
        self.cache_images = cache_images
        missing = REQUIRED_COLUMNS - set(gtboxframe.columns)
        if missing:
            raise ValueError(f"Missing columns in gtboxframe: {sorted(missing)}")
        self.gtboxframe = gtboxframe
        self.gt_path = gt_path
        self.image_path = image_path

        if image_ids is not None and image_file_names is not None:
            self.image_ids = image_ids
            self.image_file_names = image_file_names
        else:
            unique_images = gtboxframe[["imageid", "imagefilename"]].drop_duplicates()
            self.image_ids = list(unique_images["imageid"])
            self.image_file_names = list(unique_images["imagefilename"])

        if not no_image_reading:
            self._read_dataset_gt_images()
            self._read_dataset_images()
        self._annotation_cache = {}

        self.num_images = len(self.image_ids)
        self.num_boxes = len(self.gtboxframe)
        self.num_classes = len(self.gtboxframe["classfilename"].unique())
        self.logger.info(
            f"Loaded dataset {self.name} with {self.num_images} images, "
            f"{self.num_boxes} boxes, {self.num_classes} classes"
        )

    def get_name(self):
        return self.name

    def get_eval_scale(self):
        return self.eval_scale

    def get_class_ids(self):
        return self.gtboxframe["classid"].unique()

    def get_dataframe_for_image_ids(self, image_ids):
        return self.gtboxframe[self.gtboxframe["imageid"].isin(image_ids)]

    def get_image_size_for_image_id(self, image_id):
        return self.image_size_per_image_id[image_id]

    def copy_subset(self, subset_size=None):
        """The first subset_size images, with their boxes (for evaluating on a
        part of the train set; os2d_tpu/data/dataset.py:523-534)."""
        subset = copy.copy(self)
        if subset_size is not None:
            subset.num_images = min(subset_size, self.num_images)
            subset.image_ids = self.image_ids[: subset.num_images]
            subset.image_file_names = self.image_file_names[: subset.num_images]
            subset.gtboxframe = self.gtboxframe[self.gtboxframe["imageid"].isin(subset.image_ids)]
            subset.name = self.name + f"-subset{subset_size}"
            subset._annotation_cache = {}
            subset._read_dataset_gt_images()
            subset._read_dataset_images()
        return subset

    def _read_dataset_images(self):
        self.image_path_per_image_id = OrderedDict()
        self.image_size_per_image_id = OrderedDict()
        self.image_per_image_id = OrderedDict()
        for image_id, image_file in zip(self.image_ids, self.image_file_names):
            if image_id not in self.image_path_per_image_id:
                self.image_path_per_image_id[image_id] = os.path.join(
                    self.image_path, image_file
                )
                img = self._get_dataset_image_by_id(image_id)
                self.image_size_per_image_id[image_id] = FeatureMapSize.from_image(img)
        self.logger.info(
            f"{'Read' if self.cache_images else 'Found'} "
            f"{len(self.image_path_per_image_id)} data images"
        )

    def _read_dataset_gt_images(self):
        self.gt_images_per_classid = OrderedDict()
        if self.gt_path is not None:
            for _, row in self.gtboxframe.iterrows():
                class_id = row["classid"]
                if class_id not in self.gt_images_per_classid:
                    self.gt_images_per_classid[class_id] = read_image(
                        os.path.join(self.gt_path, row["classfilename"])
                    )
            self.logger.info(f"Read {len(self.gt_images_per_classid)} GT images")
        else:
            self.logger.info("GT images are not provided")

    def split_images_into_buckets_by_size(self):
        buckets = []
        bucket_sizes = []
        for image_id, s in self.image_size_per_image_id.items():
            if s not in bucket_sizes:
                bucket_sizes.append(s)
                buckets.append([])
            buckets[bucket_sizes.index(s)].append(image_id)
        return buckets

    def _get_dataset_image_by_id(self, image_id):
        if image_id not in self.image_path_per_image_id:
            raise KeyError(f"unknown image id {image_id!r}")
        if image_id not in self.image_per_image_id:
            img = read_image(self.image_path_per_image_id[image_id])
            sz = FeatureMapSize.from_image(img)
            if max(sz.w, sz.h) != self.image_size:
                # note the reference triggers on the LONGER SIDE but resizes by
                # AREA ~= image_size**2 (os2d/data/dataset.py:669-671)
                new = exact_resize_area(w=sz.w, h=sz.h, target_area_side=self.image_size)
                # the reference's Image.ANTIALIAS, an alias of LANCZOS
                img = img.resize((new.w, new.h), resample=Image.LANCZOS)
            if self.cache_images:
                self.image_per_image_id[image_id] = img
        else:
            img = self.image_per_image_id[image_id]
        return img

    def get_boxes_from_image_dataframe(self, image_data, image_size):
        if not image_data.empty:
            labels = np.asarray(list(image_data["classid"]), np.int64)
            difficult = np.asarray(list(image_data["difficult"] == 1), bool)
            boxes = image_data[["lx", "ty", "rx", "by"]].to_numpy().astype(np.float32)
            boxes[:, 0] *= image_size.w
            boxes[:, 2] *= image_size.w
            boxes[:, 1] *= image_size.h
            boxes[:, 3] *= image_size.h
            out = HostBoxes(boxes, image_size)
        else:
            out = HostBoxes.create_empty(image_size)
            labels = np.zeros((0,), np.int64)
            difficult = np.zeros((0,), bool)
        out.add_field("labels", labels)
        out.add_field("difficult", difficult)
        out.add_field("labels_original", labels.copy())
        out.add_field("difficult_original", difficult.copy())
        return out

    def get_image_annotation_for_imageid(self, image_id):
        # the GT is static: parse each image's rows once; callers may mutate
        # the returned HostBoxes fields, so each call gets a fresh copy
        cached = self._annotation_cache.get(image_id)
        if cached is None:
            image_data = self.gtboxframe[self.gtboxframe["imageid"] == image_id]
            img_size = self.image_size_per_image_id[image_id]
            cached = self.get_boxes_from_image_dataframe(image_data, img_size)
            self._annotation_cache[image_id] = cached
        return cached.copy()
